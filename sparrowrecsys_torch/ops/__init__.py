"""Kernel-backed ops and their plain PyTorch versions."""

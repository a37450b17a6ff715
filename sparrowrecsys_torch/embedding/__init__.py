"""Embedding artifact IO."""

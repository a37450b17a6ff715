"""Device choice for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`cuda` unless the caller names another device. Raises when CUDA is
    asked for (or defaulted to) and missing: the port never moves to the
    CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--cpu on the command "
            "line) to run on the CPU"
        )
    return dev

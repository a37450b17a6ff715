"""Masked embedding lookup and the embedding tables' initialiser.

The port of `sparrowrecsys_tpu/ops/embedding.py::embed_lookup` (:71-102).
Any id outside `[lo, V)` gives a zero row, where `lo` is 1 with
`mask_zero` (the history pad id 0) and 0 otherwise; ids are never
clamped onto a real row. -1 (an OOV genre) always gives zeros.

The JAX package switches between a gather and a one-hot matmul on the
TPU (`ONEHOT_GRAD_MAX_VOCAB`, `ONEHOT_FWD_MIN_DIM`); both select exactly
the same rows, so one gather gives the same values here. JAX does this
gather in XLA, not Pallas, so it stays plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def embed_lookup(
    table: torch.Tensor, ids: torch.Tensor, *, mask_zero: bool = False
) -> torch.Tensor:
    """table [V, D], integer ids [...] -> [..., D]."""
    v = table.shape[0]
    out = F.embedding(ids.clamp(0, v - 1).long(), table)
    lo = 1 if mask_zero else 0
    valid = (ids >= lo) & (ids < v)
    return torch.where(valid.unsqueeze(-1), out, out.new_zeros(()))


def uniform_embed_init(scale: float = 0.05):
    """The port of `uniform_embed_init` (`ops/embedding.py:232`): Keras's
    Embedding initialiser, uniform(-scale, scale). Returns
    `init(shape, generator, device) -> float32 tensor`. The values cannot
    match JAX's draws; the distribution does."""

    def init(shape, generator: torch.Generator, device=None) -> torch.Tensor:
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return ((2 * u - 1) * scale).to(device)

    return init

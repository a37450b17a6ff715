"""Masked embedding lookup and the embedding tables' initialiser.

The port of `sparrowrecsys_tpu/ops/embedding.py::embed_lookup` (:71-102).
Any id outside `[lo, V)` gives a zero row, where `lo` is 1 with
`mask_zero` (the history pad id 0) and 0 otherwise; ids are never
clamped onto a real row. -1 (an OOV genre) always gives zeros.

`packed_multi_lookup` gives several columns' lookups from one gather.

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


def packed_multi_lookup(tables, ids, lo=None) -> tuple:
    """Several per-column lookups, across tables of one width, as one
    gather: the port of `ops/embedding.py::packed_multi_lookup`
    (:105-175).

    tables: [V_t, D] each; ids: matching integer [B] columns; lo: each
    column's valid lower bound (1 for a history column's pad id 0, 0
    otherwise; default all 0). Returns a tuple of [B, D], each equal to
    `embed_lookup(tables[t], ids[t], mask_zero=lo[t] == 1)`: the tables
    are concatenated and every column's clamped id is offset into the
    stack. The backward is autograd's scatter-add into the stack, split
    back per table; the JAX package's custom backward sums the same rows
    (a one-hot product at V <= 2048, a scatter-add above)."""
    tables, ids = tuple(tables), tuple(ids)
    lo = tuple(lo) if lo is not None else (0,) * len(tables)
    offsets, offset = [], 0
    for t in tables:
        offsets.append(offset)
        offset += t.shape[0]
    big = torch.cat(tables)
    gidx = torch.stack([i.clamp(0, t.shape[0] - 1).long() + o
                        for i, t, o in zip(ids, tables, offsets)])      # [T, B]
    valid = torch.stack([(i >= low) & (i < t.shape[0]) for i, low, t in zip(ids, lo, tables)])
    rows = F.embedding(gidx, big)                                       # [T, B, D]
    out = torch.where(valid.unsqueeze(-1), rows, rows.new_zeros(()))
    return tuple(out.unbind(0))


def uniform_embed_init(scale: float = 0.05):
    """The port of `uniform_embed_init` (`ops/embedding.py:232`): Keras's
    Embedding initialiser, uniform(-scale, scale). Returns
    `init(shape, generator, device) -> float32 tensor`. The values cannot
    match JAX's draws; the distribution does."""

    def init(shape, generator: torch.Generator, device=None) -> torch.Tensor:
        u = torch.rand(shape, generator=generator, dtype=torch.float32)
        return ((2 * u - 1) * scale).to(device)

    return init

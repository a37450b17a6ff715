"""Masked embedding lookup and the embedding tables' initialiser.

The port of `sparrowrecsys_tpu/ops/embedding.py::embed_lookup` (:71-102).
Any id outside `[lo, V)` gives a zero row, where `lo` is 1 with
`mask_zero` (the history pad id 0) and 0 otherwise; ids are never
clamped onto a real row. -1 (an OOV genre) always gives zeros.

`packed_multi_lookup` gives several columns' lookups from one gather.

`sharded_lookup` (the port of `:187-231`) looks up a table whose rows are
split over a mesh's `model` ranks. While a step runs under
`row_sharded({block: RowShard(plan, rows)})`, every lookup of that block
(`embed_lookup`, `packed_multi_lookup`, and `models/features.py`'s
merged lookups, which fall back to one lookup per table) goes through
it, with the values of the lookup of the whole table.

The JAX package switches between a gather and a one-hot matmul on the
TPU (`ONEHOT_GRAD_MAX_VOCAB`, `ONEHOT_FWD_MIN_DIM`); both select exactly
the same rows, so one gather gives the same values here. JAX does this
gather in XLA, not Pallas, so it stays plain PyTorch.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F


class RowShard(NamedTuple):
    """A row block of a table split over `plan`'s model ranks: rank m holds
    rows [m * block, (m + 1) * block) of a table of `rows` rows."""

    plan: Any
    rows: int


#: id(block) -> (block, RowShard) for the lookups of the running step.
_ROW_SHARDS: contextvars.ContextVar[Optional[Dict[int, tuple]]] = contextvars.ContextVar(
    "row_shards", default=None)


@contextlib.contextmanager
def row_sharded(blocks: Dict[torch.Tensor, RowShard]):
    """Route the lookups of these row blocks (the very tensors, and the
    casts `cast_rows` makes of them) through `sharded_lookup` inside the
    block."""
    token = _ROW_SHARDS.set({id(t): (t, s) for t, s in blocks.items()})
    try:
        yield
    finally:
        _ROW_SHARDS.reset(token)


def row_shard_of(table: torch.Tensor) -> Optional[RowShard]:
    reg = _ROW_SHARDS.get()
    hit = reg.get(id(table)) if reg else None
    return hit[1] if hit is not None and hit[0] is table else None


def cast_rows(table: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`table.to(dtype)`; a row block's cast stays a row block."""
    out = table.to(dtype)
    shard = row_shard_of(table)
    if shard is not None and out is not table:
        _ROW_SHARDS.get()[id(out)] = (out, shard)
    return out


class _ShardedLookup(torch.autograd.Function):
    """Forward: this shard's rows, zeros elsewhere, summed over `model`.
    Backward: the cotangent (the same on every model rank) scatter-added
    into the rows this shard owns, with no second sum."""

    @staticmethod
    def forward(ctx, block, ids, plan, rows):
        n = block.shape[0]
        local = ids.long() - plan.model_index * n
        hit = (local >= 0) & (local < n) & (ids < rows)
        safe = torch.where(hit, local, 0)
        part = torch.where(hit.unsqueeze(-1), F.embedding(safe, block), block.new_zeros(()))
        ctx.save_for_backward(safe, hit)
        ctx.n = n
        return plan.all_reduce(part, plan.model_axis)

    @staticmethod
    def backward(ctx, g):
        safe, hit = ctx.saved_tensors
        g = torch.where(hit.unsqueeze(-1), g, g.new_zeros(()))
        grad = torch.ops.aten.embedding_dense_backward(g.contiguous(), safe, ctx.n, -1, False)
        return grad, None, None, None


def sharded_lookup(table_block: torch.Tensor, ids: torch.Tensor, plan,
                   *, rows: Optional[int] = None) -> torch.Tensor:
    """Lookup into a table row-sharded over `plan`'s model axis.

    table_block [block, D]: this rank's contiguous rows of the table
    padded to block * n_model rows; ids [...]: raw row ids, the same on
    every model rank (this rank's data shard). Returns [..., D], the same
    on every model rank: row `id` of the table, zeros for an id outside
    [0, rows) (default: the padded row count). Each shard gathers the
    rows it owns and zero-fills the rest; the parts are summed over
    `model`, which is exact (one shard holds each row)."""
    rows = table_block.shape[0] * plan.n_model if rows is None else rows
    return _ShardedLookup.apply(table_block, ids, plan, rows)


def _lookup_from(table: torch.Tensor, ids: torch.Tensor, lo: int) -> torch.Tensor:
    """`embed_lookup` with valid ids in [lo, V)."""
    return embed_lookup(table, torch.where(ids >= lo, ids, -1)) if lo else embed_lookup(table, ids)


def embed_lookup(
    table: torch.Tensor, ids: torch.Tensor, *, mask_zero: bool = False
) -> torch.Tensor:
    """table [V, D], integer ids [...] -> [..., D]."""
    shard = row_shard_of(table)
    if shard is not None:
        return sharded_lookup(table, torch.where(ids >= 1, ids, -1) if mask_zero else ids,
                              shard.plan, rows=shard.rows)
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
    if any(row_shard_of(t) is not None for t in tables):
        # A row block holds part of its table: one lookup per table.
        return tuple(_lookup_from(t, i, low) for t, i, low in zip(tables, ids, lo))
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

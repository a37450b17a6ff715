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
gather in XLA, not Pallas, so the forward stays plain PyTorch.

The backward of a dense lookup into a float32 table on the card whose
gradient fits in shared memory (`bwd_fits`: V * D * 4 <= `MAX_TABLE_BYTES`,
D <= `MAX_DIM`) is `embedding_bwd`, the hand-written kernel of
`csrc/embedding_bwd.cu`: one pass over the rows with the lookup's mask
inside, no sort, and the blocks' partial tables added in a fixed order.
`embedding_bwd_plain` is its plain PyTorch twin, with the same split of
the rows into blocks. Every other lookup (larger tables, other dtypes,
CPU tables, lookups with no gradient to make) runs the ops it always ran.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from sparrowrecsys_torch.ops import kernels
from sparrowrecsys_torch.utils.profiling import backward_span


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


def _masked_gather(table: torch.Tensor, ids: torch.Tensor, lo: int) -> torch.Tensor:
    v = table.shape[0]
    out = F.embedding(ids.clamp(0, v - 1).long(), table)
    valid = (ids >= lo) & (ids < v)
    return torch.where(valid.unsqueeze(-1), out, out.new_zeros(()))


# ---- the small-table backward -------------------------------------------

#: Dynamic shared memory a block of the H100 can opt into (227 KB).
SMEM_LIMIT = 232448
#: The largest table whose gradient the kernel holds in shared memory,
#: V * D * 4 bytes: DIN's and DIEN's movie table (1,001 x 10, 40,040 bytes),
#: DeepFM's merged movie table and bias (1,001 x 11), the genre tables and
#: the [V, 1] bias columns fit; the 30,001-row user table does not.
MAX_TABLE_BYTES = 64 * 1024
#: The widest row: three stages of a 32-row tile beside one copy of the
#: largest table fit in SMEM_LIMIT.
MAX_DIM = 256
#: Warps of a block (`kThreads` / 32 in csrc/embedding_bwd.cu).
BWD_WARPS = 8
#: Tiles staged at once (`kStages`).
STAGES = 3
#: The bytes of g and ids a tile aims at: two tiles in flight per SM.
TILE_BYTES = 20 * 1024
#: The H100's SMs: the twin's split of the rows on the CPU.
H100_SMS = 132
#: The id dtypes the kernel reads as they are.
_ID_DTYPES = (torch.int32, torch.int64)
#: Devices whose lookups take the kernel's backward.
_KERNEL_DEVICES = ("cuda",)


class BwdPlan(NamedTuple):
    """How the kernel splits N rows: `copies` of the [V, D] gradient in a
    block's shared memory, `warps_per_copy` splitting a row's words, tiles of
    `tile_rows` (a multiple of 32 * copies), `rows_per_block` (whole tiles)
    for each of `grid` blocks, and the block's `smem_bytes`."""

    copies: int
    warps_per_copy: int
    tile_rows: int
    rows_per_block: int
    grid: int
    smem_bytes: int


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def bwd_smem(v: int, d: int, id_bytes: int, copies: int, tile_rows: int) -> int:
    """A block's shared memory: the copies of the table, then STAGES tiles
    of g rows and ids (each part 16-byte aligned)."""
    return _align16(copies * v * d * 4) + STAGES * (
        _align16(tile_rows * d * 4) + _align16(tile_rows * id_bytes))


def bwd_fits(v: int, d: int) -> bool:
    """Whether the kernel takes a [V, D] table's gradient."""
    return 0 < v * d * 4 <= MAX_TABLE_BYTES and 0 < d <= MAX_DIM


def bwd_plan(n: int, v: int, d: int, id_bytes: int, sms: int = H100_SMS) -> BwdPlan:
    """The kernel's plan for N rows into a [V, D] table with ids of
    `id_bytes`, on a card of `sms` SMs: the most copies of the table (8, 4,
    2, 1) that fit in SMEM_LIMIT beside three tiles, the tile the largest
    whole number of 32 * copies rows within TILE_BYTES (at least one), cut
    until it fits; then whole tiles split evenly over at most `sms`
    blocks. Raises ValueError for a table outside `bwd_fits`."""
    if not bwd_fits(v, d):
        raise ValueError(f"embedding_bwd: a [{v}, {d}] table does not fit the kernel's budget "
                         f"(V*D*4 <= {MAX_TABLE_BYTES}, D <= {MAX_DIM})")
    row_bytes = d * 4 + id_bytes
    for copies in (8, 4, 2, 1):
        unit = 32 * copies
        k = max(1, TILE_BYTES // (unit * row_bytes))
        while k > 1 and bwd_smem(v, d, id_bytes, copies, unit * k) > SMEM_LIMIT:
            k -= 1
        smem = bwd_smem(v, d, id_bytes, copies, unit * k)
        if smem <= SMEM_LIMIT:
            tile = unit * k
            tiles = -(-n // tile)
            per_block = max(1, -(-tiles // sms)) * tile
            return BwdPlan(copies, BWD_WARPS // copies, tile, per_block, -(-n // per_block), smem)
    raise AssertionError(f"bwd_fits({v}, {d}) holds but no plan fits")  # MAX_DIM rules it out


@functools.lru_cache(maxsize=256)
def _bwd_plan_on(n: int, v: int, d: int, id_bytes: int, dev: int) -> BwdPlan:
    """`bwd_plan` on card `dev` for one launch shape, which a trainer
    repeats step after step."""
    return bwd_plan(n, v, d, id_bytes, torch.cuda.get_device_properties(dev).multi_processor_count)


_BWD = kernels.TABLE["embedding_bwd"]


def embedding_bwd_plain(g: torch.Tensor, ids: torch.Tensor, v: int, lo: int,
                        sms: int = H100_SMS) -> torch.Tensor:
    """The kernel's twin: each of the plan's blocks' rows index-added into
    a zero [V, D], rows with an id outside [lo, V) left out, and the
    blocks' partials added in block order."""
    d = g.shape[-1]
    flat, rows = ids.reshape(-1), g.reshape(-1, d)
    n = flat.numel()
    out = g.new_zeros((v, d))
    if n == 0:
        return out
    per_block = bwd_plan(n, v, d, ids.element_size(), sms).rows_per_block
    for start in range(0, n, per_block):
        i, r = flat[start:start + per_block], rows[start:start + per_block]
        keep = (i >= lo) & (i < v)
        out += g.new_zeros((v, d)).index_add_(0, i[keep].long(), r[keep])
    return out


def embedding_bwd(g: torch.Tensor, ids: torch.Tensor, v: int, lo: int) -> torch.Tensor:
    """The gradient [V, D] of a [V, D] float32 table for the masked lookup
    of `ids` (integer [...], as the lookup was given them) whose output
    gradient is g [..., D]: the sum of g's rows by id over the ids in
    [lo, V). A CPU tensor takes the twin; a CUDA tensor launches the kernel
    of `csrc/embedding_bwd.cu` or raises."""
    if g.is_cpu:
        return embedding_bwd_plain(g, ids, v, lo)
    dev = g.get_device()
    if dev < 0 or ids.get_device() != dev:
        raise ValueError(f"embedding_bwd: g on {g.device}, ids on {ids.device}")
    if g.dtype is not torch.float32 or ids.dtype not in _ID_DTYPES:
        raise ValueError(f"embedding_bwd: takes float32 g and int32 or int64 ids, got "
                         f"{g.dtype} and {ids.dtype}")
    if not (g.is_contiguous() and ids.is_contiguous()):
        raise ValueError("embedding_bwd: the kernel takes contiguous tensors")
    d, n = g.shape[-1], ids.numel()
    if g.numel() != n * d or lo not in (0, 1):
        raise ValueError(f"embedding_bwd: g {tuple(g.shape)} for ids {tuple(ids.shape)}, "
                         f"lo {lo}")
    id_bytes = ids.element_size()
    plan = _bwd_plan_on(n, v, d, id_bytes, dev)
    partials = torch.empty(plan.grid * v * d, dtype=torch.float32, device=g.device)
    out = torch.empty((v, d), dtype=torch.float32, device=g.device)
    _BWD(dev, g.data_ptr(), ids.data_ptr(), partials.data_ptr(), out.data_ptr(),
         kernels.scalars(n, v, d, lo, id_bytes, plan.copies, plan.warps_per_copy, plan.tile_rows,
                         plan.rows_per_block, plan.grid, dev))
    return out


class _MaskedLookup(torch.autograd.Function):
    """The dense lookup, its forward the very ops of `_masked_gather`; the
    backward is `embedding_bwd` on the raw ids, which applies the mask
    itself (no `where` backward, no clamped copy of the ids kept)."""

    @staticmethod
    def forward(ctx, table, ids, lo):
        ctx.save_for_backward(ids)
        ctx.v, ctx.lo = table.shape[0], lo
        return _masked_gather(table, ids, lo)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return embedding_bwd(g.contiguous(), ids.contiguous(), ctx.v, ctx.lo), None, None


def takes_kernel(table: torch.Tensor, ids: torch.Tensor) -> bool:
    """Whether a dense lookup's backward is `embedding_bwd`: a float32
    table on the card that needs a gradient (grad enabled), whose gradient
    fits (`bwd_fits`), looked up by int32 or int64 ids."""
    return (table.requires_grad and torch.is_grad_enabled()
            and table.device.type in _KERNEL_DEVICES and table.dtype is torch.float32
            and ids.dtype in _ID_DTYPES and table.dim() == 2 and bwd_fits(*table.shape))


def _dense_lookup(table: torch.Tensor, ids: torch.Tensor, lo: int) -> torch.Tensor:
    if takes_kernel(table, ids):
        return _MaskedLookup.apply(table, ids, lo)
    return _masked_gather(table, ids, lo)


def embed_lookup(
    table: torch.Tensor, ids: torch.Tensor, *, mask_zero: bool = False
) -> torch.Tensor:
    """table [V, D], integer ids [...] -> [..., D]. Its backward is the
    profiler range `embedding.backward` while a profiler records."""
    shard = row_shard_of(table)
    if shard is not None:
        return backward_span("embedding.backward", sharded_lookup, table,
                             torch.where(ids >= 1, ids, -1) if mask_zero else ids,
                             shard.plan, rows=shard.rows)
    return backward_span("embedding.backward", _dense_lookup, table, ids, 1 if mask_zero else 0)


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

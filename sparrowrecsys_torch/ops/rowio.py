"""Row gather and row write on an embedding-sized table.

The port of `sparrowrecsys_tpu/ops/rowio.py`: `rows_gather_pallas` (:103)
and `rows_write_pallas` (:172). The lazy row-Adam
(`training/row_optim.py`) moves its touched rows with them.

- `rows_gather_plain`, `rows_write_plain`: the plain PyTorch versions.
- `rows_gather(table [V, D], ids [U]) -> [U, D]`: `table[ids]`. The caller
  guarantees ids in [0, V), as on the TPU; the kernel writes a zero row
  for any other id rather than read outside the table.
- `rows_write(table, ids, rows)`: `table[ids] = rows` IN PLACE, skipping
  ids outside [0, V) (XLA's `mode="drop"`). JAX donates the table to the
  kernel and gets it back; the port mutates the tensor it is given and
  returns it. The ids must be DISTINCT (the row optimizer's sorted unique
  ids are): with a repeated id two rows race for one slot. The wrapper
  does not check, which would cost a sort.

A CPU tensor takes the plain version; a CUDA tensor launches the
hand-written kernel of `csrc/rowio.cu` or raises. Unlike the TPU kernels
(f32 rows of exactly 128 lanes), these take any D, in any dtype whose row
is a whole number of 2-byte words: a group of lanes copies a row in the
widest words the row width and pointers allow, several rows in flight
(`launch_plan`).

The kernels take a few microseconds of device time, so the host's work
per call sets their rate: each wrapper reads every tensor attribute it
checks once, looks up its launch's scalars in a cache (`_scalars`), and
reads the raw stream handle (`kernels.stream_of`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from sparrowrecsys_torch.ops import kernels

#: Threads in a block of the row kernels (`kThreads` in csrc/rowio.cu).
THREADS = 256
#: Rows each lane group keeps in flight (`R` in csrc/rowio.cu).
ROWS_IN_FLIGHT = 2
#: One resident wave of row-kernel blocks on the H100: 132 SMs x 8 blocks
#: of 256 threads. A larger grid is cut to it, and its blocks then loop
#: over the rows (grid-stride).
MAX_GRID = 132 * 8
#: Word widths in bytes, widest first.
WORDS = (16, 8, 4, 2)


class Plan(NamedTuple):
    """How the row kernels move U rows: `word_bytes` a lane moves at
    once, `lanes` per row group (a power of two, at most 32), and `grid`
    blocks of `THREADS`, each taking THREADS / lanes * ROWS_IN_FLIGHT
    rows."""

    word_bytes: int
    lanes: int
    grid: int


def lanes_for(words: int) -> int:
    """Lanes of a row group for rows of `words` words: the smallest power
    of two that covers them, at most 32 (a wider row loops)."""
    return 1 << (min(words, 32) - 1).bit_length()


def _plan(row_bytes: int, misalign: int, u: int) -> Plan:
    for word in WORDS:
        if row_bytes % word == 0 and misalign % word == 0:
            lanes = lanes_for(row_bytes // word)
            block_rows = THREADS // lanes * ROWS_IN_FLIGHT
            return Plan(word, lanes, min(-(-u // block_rows), MAX_GRID))
    raise ValueError(f"a row of {row_bytes} bytes at these pointers is not a whole "
                     f"number of aligned {WORDS[-1]}-byte words")


def launch_plan(row_bytes: int, ptr_a: int, ptr_b: int, u: int) -> Plan:
    """The row kernels' plan for U rows of `row_bytes` (> 0) copied from
    or to the row pointers `ptr_a` and `ptr_b`: the widest word of
    `WORDS` that divides the row and aligns both pointers; the smallest
    power of two of lanes that covers the row's words, at most 32 (wider
    rows loop within the group); a grid that covers U, cut to `MAX_GRID`.
    Raises ValueError where no 2-byte word fits (an odd byte width)."""
    return _plan(row_bytes, (ptr_a | ptr_b) & 15, u)


@functools.lru_cache(maxsize=1024)
def _scalars(row_bytes: int, misalign: int, u: int, v: int, dev: int):
    """The entry points' int64 scalars for one launch shape: V, U, row
    bytes, the plan, device. Cached on the shape, the pointers' alignment
    and the device, which a trainer repeats step after step: a call then
    looks the array up and ctypes converts five arguments, not eleven."""
    return (ctypes.c_int64 * 7)(v, u, row_bytes, *_plan(row_bytes, misalign, u), dev)


def rows_gather_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table.index_select(0, ids.long())


def rows_write_plain(table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    keep = (ids >= 0) & (ids < table.shape[0])
    table[ids[keep].long()] = rows[keep].to(table.dtype)
    return table


def _check(name, dev, table, ids, rows=None):
    """Raise unless the kernel takes these tensors (`dev`: the table's
    `get_device()`), reading each attribute once; returns (V, D, U)."""
    if dev < 0:
        raise ValueError(f"{name}: expected CUDA or CPU tensors, got {table.device}")
    if ids.get_device() != dev:
        raise ValueError(f"{name}: ids on {ids.device}, table on {table.device}")
    if ids.dtype is not torch.int32 or not ids.is_contiguous():
        raise ValueError(f"{name}: ids must be a contiguous 1-D int32 tensor")
    try:
        (u,), (v, d) = ids.shape, table.shape
    except ValueError:
        raise ValueError(f"{name}: ids must be 1-D and the table [V, D], got "
                         f"{tuple(ids.shape)} and {tuple(table.shape)}") from None
    if not table.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    if rows is not None:
        if rows.get_device() != dev:
            raise ValueError(f"{name}: rows on {rows.device}, table on {table.device}")
        if rows.dtype is not table.dtype:
            raise ValueError(f"{name}: rows of {rows.dtype} for a table of {table.dtype}")
        if not rows.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
        if rows.shape != (u, d):
            raise ValueError(f"{name}: rows {tuple(rows.shape)} != {(u, d)}")
    return v, d, u


def rows_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """[V, D] table, [U] int32 ids in [0, V) -> [U, D] rows."""
    dev = table.get_device()  # -1 off the card
    if dev < 0 and table.is_cpu:
        return rows_gather_plain(table, ids)
    v, d, u = _check("rows_gather", dev, table, ids)
    out = table.new_empty((u, d))
    if u and d:
        tp, op = table.data_ptr(), out.data_ptr()
        row_bytes = d * table.itemsize
        scalars = _scalars(row_bytes, (tp | op) & 15, u, v, dev)
        lib = kernels.library()
        err = lib.rows_gather(tp, ids.data_ptr(), op, scalars, kernels.stream_of(dev))
        if err:
            kernels.check(lib, err, "rows_gather")
        rows_gather.launches += 1
    return out


def rows_write(table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """table[ids] = rows in place for distinct ids; ids outside [0, V)
    are skipped. Returns `table`."""
    dev = table.get_device()
    if dev < 0 and table.is_cpu:
        return rows_write_plain(table, ids, rows)
    v, d, u = _check("rows_write", dev, table, ids, rows)
    if u and d:
        tp, rp = table.data_ptr(), rows.data_ptr()
        row_bytes = d * table.itemsize
        scalars = _scalars(row_bytes, (tp | rp) & 15, u, v, dev)
        lib = kernels.library()
        err = lib.rows_write(tp, ids.data_ptr(), rp, scalars, kernels.stream_of(dev))
        if err:
            kernels.check(lib, err, "rows_write")
        rows_write.launches += 1
    return table


#: Kernel launches since the last reset (plain integers on the wrappers).
rows_gather.launches = 0
rows_write.launches = 0

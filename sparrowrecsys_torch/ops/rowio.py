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
(f32 rows of exactly 128 lanes), these take any D, in any dtype: one warp
copies a row in 16-byte words where the row width and pointers allow.
"""

from __future__ import annotations

import torch

from sparrowrecsys_torch.ops import kernels


def rows_gather_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table.index_select(0, ids.long())


def rows_write_plain(table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    keep = (ids >= 0) & (ids < table.shape[0])
    table[ids[keep].long()] = rows[keep].to(table.dtype)
    return table


def _check(name, table, ids, rows=None):
    if ids.device != table.device:
        raise ValueError(f"{name}: ids on {ids.device}, table on {table.device}")
    if ids.dtype != torch.int32 or ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError(f"{name}: ids must be a contiguous 1-D int32 tensor")
    if table.dim() != 2:
        raise ValueError(f"{name}: table must be [V, D], got {tuple(table.shape)}")
    tensors = (table,) if rows is None else (table, rows)
    kernels.require_cuda(name, *tensors, dtypes=(table.dtype,))
    if rows is not None and tuple(rows.shape) != (ids.shape[0], table.shape[1]):
        raise ValueError(f"{name}: rows {tuple(rows.shape)} != {(ids.shape[0], table.shape[1])}")


def rows_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """[V, D] table, [U] int32 ids in [0, V) -> [U, D] rows."""
    if table.device.type == "cpu":
        return rows_gather_plain(table, ids)
    _check("rows_gather", table, ids)
    out = torch.empty((ids.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    lib = kernels.library()
    err = lib.rows_gather(table.data_ptr(), ids.data_ptr(), out.data_ptr(),
                          table.shape[0], ids.shape[0], table.shape[1] * table.element_size(),
                          table.device.index or 0, kernels.stream_of(table))
    kernels.check(lib, err, "rows_gather")
    rows_gather.launches += 1
    return out


def rows_write(table: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """table[ids] = rows in place for distinct ids; ids outside [0, V)
    are skipped. Returns `table`."""
    if table.device.type == "cpu":
        return rows_write_plain(table, ids, rows)
    _check("rows_write", table, ids, rows)
    if rows.numel() == 0:
        return table
    lib = kernels.library()
    err = lib.rows_write(table.data_ptr(), ids.data_ptr(), rows.data_ptr(),
                         table.shape[0], ids.shape[0], table.shape[1] * table.element_size(),
                         table.device.index or 0, kernels.stream_of(table))
    kernels.check(lib, err, "rows_write")
    rows_write.launches += 1
    return table


#: Kernel launches since the last reset (plain integers on the wrappers).
rows_gather.launches = 0
rows_write.launches = 0

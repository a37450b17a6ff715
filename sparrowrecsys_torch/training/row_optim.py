"""Row-sparse (lazy) Adam for large embedding tables: the port of
`sparrowrecsys_tpu/training/row_optim.py`.

Only the rows the step's feature ids touched are updated: gather their
moment rows, run Adam's arithmetic (`training/optim.py`, bit-equal to the
JAX package's), write them back. Untouched rows' moments are frozen, not
decayed (LazyAdam), and bias correction uses the global step count.

Two layouts:
- `row_adam_update` on `RowAdamState(count, mu, nu)`: separate moment
  arrays, three row writes.
- `fused_row_adam_update` on `FusedRowAdamState(count, buf)` with
  `buf = [table | mu | nu]`, one [V, 3D] tensor: one [U, 3D] gather, one
  [U, D] gradient gather and one [U, 3D] write. The Trainer's
  `sparse_tables=` path uses it.

The rows move through `ops/rowio.py`: on the card the hand-written row
kernels, on the CPU their plain versions. Where JAX returns new arrays
(and donates the old ones), the port writes the rows IN PLACE into the
tensors it is given and returns them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sparrowrecsys_torch.ops.rowio import rows_gather, rows_write
from sparrowrecsys_torch.training.optim import adam_moments, adam_step, bias_corrections


class RowAdamState(NamedTuple):
    count: torch.Tensor  # int32 global step (shared bias correction)
    mu: torch.Tensor     # [V, D] first moment (frozen for untouched rows)
    nu: torch.Tensor     # [V, D] second moment


def init_row_adam(table: torch.Tensor) -> RowAdamState:
    return RowAdamState(
        count=torch.zeros((), dtype=torch.int32, device=table.device),
        mu=torch.zeros_like(table),
        nu=torch.zeros_like(table),
    )


def _touched_rows(ids: torch.Tensor, v: int):
    """Flatten ids to (uids, safe), both int32 of the flat size: `uids`
    sorted ascending and distinct, every drop slot >= v; `safe` =
    clip(uids, 0, v-1) for reads (sorted, not distinct).

    Every id outside [0, v) is first routed to v; the unique ids are
    padded to the flat size with v, and each v-valued slot (all at the
    tail, v being the largest value) becomes v + its position, so the ids
    stay strictly increasing and every drop slot stays out of range."""
    flat = ids.reshape(-1).to(torch.int32)
    n = flat.numel()
    if v + n >= 2 ** 31:
        raise ValueError("fill-slot ids would overflow int32")
    flat = torch.where((flat < 0) | (flat >= v), torch.full_like(flat, v), flat)
    uniq = torch.unique(flat, sorted=True)
    uids = torch.full((n,), v, dtype=torch.int32, device=flat.device)
    uids[: uniq.numel()] = uniq
    pos = torch.arange(n, dtype=torch.int32, device=flat.device)
    uids = torch.where(uids == v, v + pos, uids)
    return uids, uids.clamp(0, v - 1)


def row_adam_update(
    table: torch.Tensor,
    state: RowAdamState,
    grad: torch.Tensor,
    ids: torch.Tensor,
    *,
    learning_rate: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-7,
):
    """One lazy-Adam step on the rows `ids` touch (three-array layout).

    table/grad/mu/nu: [V, D]; ids: int32, any shape (flattened).
    Duplicate ids are collapsed (the dense grad already summed them);
    out-of-range ids are ignored. Updates `table`, `state.mu` and
    `state.nu` in place; returns (table, new state)."""
    v = table.shape[0]
    uids, safe = _touched_rows(ids, v)
    count = state.count + 1
    c1, c2 = bias_corrections(count, b1, b2)
    g = rows_gather(grad.contiguous(), safe)
    mu_new, nu_new = adam_moments(rows_gather(state.mu, safe), rows_gather(state.nu, safe),
                                  g, b1, b2)
    upd = adam_step(mu_new, nu_new, c1, c2, learning_rate, eps)
    rows_write(table, uids, rows_gather(table, safe) + upd)
    rows_write(state.mu, uids, mu_new)
    rows_write(state.nu, uids, nu_new)
    return table, RowAdamState(count=count, mu=state.mu, nu=state.nu)


class FusedRowAdamState(NamedTuple):
    count: torch.Tensor  # int32 global step (shared bias correction)
    buf: torch.Tensor    # [V, 3D] = [table | mu | nu] side by side


def init_fused_row_adam(table: torch.Tensor) -> FusedRowAdamState:
    z = torch.zeros_like(table)
    return FusedRowAdamState(
        count=torch.zeros((), dtype=torch.int32, device=table.device),
        buf=torch.cat([table, z, z], dim=1).contiguous(),
    )


def fused_table(state: FusedRowAdamState) -> torch.Tensor:
    """The parameter table, [V, D]: a strided view of buf's first D columns."""
    return state.buf[:, : state.buf.shape[1] // 3]


def fused_row_adam_update(
    state: FusedRowAdamState,
    grad: torch.Tensor,
    ids: torch.Tensor,
    *,
    learning_rate: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-7,
) -> FusedRowAdamState:
    """One lazy-Adam step as one [U, 3D] gather, one [U, D] gradient gather
    and one [U, 3D] write, in place into `state.buf`. Same arithmetic as
    `row_adam_update`. grad: the dense [V, D] gradient of the table."""
    v, d3 = state.buf.shape
    d = d3 // 3
    uids, safe = _touched_rows(ids, v)
    count = state.count + 1
    c1, c2 = bias_corrections(count, b1, b2)
    rows = rows_gather(state.buf, safe)                  # [U, 3D]
    g = rows_gather(grad.contiguous(), safe)             # [U, D]
    mu_new, nu_new = adam_moments(rows[:, d:2 * d], rows[:, 2 * d:], g, b1, b2)
    upd = adam_step(mu_new, nu_new, c1, c2, learning_rate, eps)
    new_rows = torch.cat([rows[:, :d] + upd, mu_new, nu_new], dim=1)
    rows_write(state.buf, uids, new_rows)
    return FusedRowAdamState(count=count, buf=state.buf)

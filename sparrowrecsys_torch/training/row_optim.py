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
  [U, D] gradient gather and one [U, 3D] write.
  `fused_row_adam_update_many` steps several such tables at once, Adam's
  arithmetic run once over all their gathered rows; the Trainer's
  `sparse_tables=` path uses it.

The rows move through `ops/rowio.py`: on the card the hand-written row
kernels, on the CPU their plain versions. Where JAX returns new arrays
(and donates the old ones), the port writes the rows IN PLACE into the
tensors it is given and returns them.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

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

    Every id outside [0, v) is first routed to v; `uids` is v + each
    slot's position with its head replaced by the unique ids, except that a
    unique v (the last, v being the largest value) keeps v + its position.
    So the ids stay strictly increasing and every drop slot stays out of
    range."""
    flat = ids.reshape(-1).to(torch.int32)
    n = flat.numel()
    if v + n >= 2 ** 31:
        raise ValueError("fill-slot ids would overflow int32")
    uniq = torch.unique(torch.where((flat < 0) | (flat >= v), v, flat), sorted=True)
    uids = torch.arange(v, v + n, dtype=torch.int32, device=flat.device)
    head = uids[: uniq.numel()]
    head.copy_(torch.where(uniq == v, head, uniq))
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
    """[table | 0 | 0] in a new buffer, the table copied in once."""
    v, d = table.shape
    buf = table.new_zeros((v, 3 * d))
    buf[:, :d] = table
    return FusedRowAdamState(
        count=torch.zeros((), dtype=torch.int32, device=table.device), buf=buf)


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
    return fused_row_adam_update_many([state], [grad], [ids], learning_rate=learning_rate,
                                      b1=b1, b2=b2, eps=eps)[0]


def fused_row_adam_update_many(
    states: Sequence[FusedRowAdamState],
    grads: Sequence[torch.Tensor],
    ids: Sequence[torch.Tensor],
    *,
    learning_rate: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-7,
) -> List[FusedRowAdamState]:
    """`fused_row_adam_update` on several tables that step together (the
    trainer's sparse tables, one step count): each table's touched rows
    routed and gathered as for one table, the tables of one width and dtype
    into one [sum U, 3D] block and one [sum U, D] gradient block, Adam's
    arithmetic once over each block, and each table's rows written back. The
    arithmetic is elementwise, so each table gets the bits it would get
    alone; the host launches one set of Adam's ops a width instead of one a
    table. Returns the new states in the order given; they share one count
    (the first state's, plus one)."""
    count = states[0].count + 1
    c1, c2 = bias_corrections(count, b1, b2)
    routed = [_touched_rows(i, st.buf.shape[0]) for st, i in zip(states, ids)]
    groups: Dict[tuple, List[int]] = {}
    for t, st in enumerate(states):
        groups.setdefault((st.buf.shape[1], st.buf.dtype), []).append(t)
    for members in groups.values():
        buf0 = states[members[0]].buf
        d = buf0.shape[1] // 3
        sizes = [routed[t][0].numel() for t in members]
        rows = buf0.new_empty((sum(sizes), 3 * d))                   # [U, 3D]
        g = grads[members[0]].new_empty((sum(sizes), d))             # [U, D]
        for t, r, gg in zip(members, rows.split(sizes), g.split(sizes)):
            rows_gather(states[t].buf, routed[t][1], out=r)
            rows_gather(grads[t].contiguous(), routed[t][1], out=gg)
        mu_new, nu_new = adam_moments(rows[:, d:2 * d], rows[:, 2 * d:], g, b1, b2)
        upd = adam_step(mu_new, nu_new, c1, c2, learning_rate, eps)
        new_rows = torch.cat([rows[:, :d] + upd, mu_new, nu_new], dim=1)
        for t, r in zip(members, new_rows.split(sizes)):
            rows_write(states[t].buf, routed[t][0], r)
    return [FusedRowAdamState(count=count, buf=st.buf) for st in states]

"""The port's row kernels' plain versions and optimizers against the JAX
package's, on the same numpy inputs.

- `rows_gather_plain`/`rows_write_plain` against `rows_gather_pallas`/
  `rows_write_pallas` in interpret mode (f32 rows of 128, the TPU
  kernels' only shape) and against `jnp.take`/`.at[].set(mode="drop")`
  at other widths and in bf16: a row copy is exact, so bit-equal.
- `grouped_adam`, `row_adam_update` and `fused_row_adam_update` over 5
  steps on identical gradients: bit-equal (see training/optim.py for the
  two roundings that takes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparrowrecsys_torch.ops import kernels
from sparrowrecsys_torch.ops.rowio import rows_gather, rows_gather_plain, rows_write, rows_write_plain
from sparrowrecsys_torch.training import row_optim as trow
from sparrowrecsys_torch.training.optim import grouped_adam
from sparrowrecsys_tpu.ops import rowio as jax_rowio
from sparrowrecsys_tpu.training import row_optim as jrow
from sparrowrecsys_tpu.training.optim import grouped_adam as jax_grouped_adam

torch.set_num_threads(2)


def _table(v, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(v, d)).astype(np.float32), rng


def test_row_plain_versions_match_the_pallas_kernels_in_interpret_mode():
    table, rng = _table(300, 128, np.float32)
    ids = np.sort(rng.choice(300, size=64, replace=False)).astype(np.int32)
    rows = rng.normal(size=(64, 128)).astype(np.float32)
    ref = jax_rowio.rows_gather_pallas(jnp.asarray(table), jnp.asarray(ids), block=32,
                                       interpret=True)
    got = rows_gather_plain(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    drop = ids.copy()
    drop[::5] = -1
    drop[1::9] = 300 + np.arange(len(drop[1::9]))     # drop slots past V
    ref = jax_rowio.rows_write_pallas(jnp.asarray(table), jnp.asarray(drop),
                                      jnp.asarray(rows), block=32, interpret=True)
    got = rows_write_plain(torch.from_numpy(table.copy()), torch.from_numpy(drop),
                           torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [30, 7])
def test_row_wrappers_match_take_and_drop_set(dtype, d):
    """The CPU wrappers (plain versions) at widths the TPU kernels never
    took, with ids of -1 and >= V for the write."""
    table, rng = _table(50, d, np.float32, seed=d)
    ids = rng.choice(50, size=20, replace=False).astype(np.int32)
    rows = rng.normal(size=(20, d)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jt = jnp.asarray(table, jdt)
    tt = torch.from_numpy(table).to(tdt)
    got = rows_gather(tt, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jnp.take(jt, jnp.asarray(ids), axis=0), np.float32))
    drop = ids.copy()
    drop[0], drop[3], drop[7] = -1, 50, 1000
    # -1 is skipped, as rows_write_pallas's kernel skips it (the test
    # above); XLA's scatter would wrap it onto row V-1, so the reference
    # sends it past V instead.
    ref = jt.at[jnp.asarray(np.where(drop < 0, 50, drop))].set(jnp.asarray(rows, jdt),
                                                               mode="drop")
    out = rows_write(tt.clone(), torch.from_numpy(drop), torch.from_numpy(rows).to(tdt))
    assert out.dtype == tdt
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))


def test_rows_write_works_in_place_and_launches_nothing_on_the_cpu():
    t = torch.zeros(5, 3)
    before = kernels.launch_counts()
    out = rows_write(t, torch.tensor([4, -1], dtype=torch.int32), torch.ones(2, 3))
    assert out is t and t[4].eq(1).all() and t[:4].eq(0).all()
    assert kernels.launch_counts() == before


def test_touched_rows_match_jax():
    rng = np.random.default_rng(3)
    ids = rng.integers(-4, 60, size=(6, 7)).astype(np.int32)
    ref_u, ref_s = jrow._touched_rows(jnp.asarray(ids), 50)
    u, s = trow._touched_rows(torch.from_numpy(ids), 50)
    np.testing.assert_array_equal(u.numpy(), np.asarray(ref_u))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))


def _grads(rng, shapes):
    """Gradients spanning 10 decades, where Adam's rounding shows."""
    return {k: (rng.normal(size=s) * 10.0 ** rng.integers(-8, 2, size=s)).astype(np.float32)
            for k, s in shapes.items()}


def test_grouped_adam_is_bit_equal_to_jax_over_five_steps():
    rng = np.random.default_rng(0)
    shapes = {"a": (300, 7), "big": (70000,), "c": (5,), "d": (3, 1)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jtx = jax_grouped_adam(1e-3, eps=1e-7)
    jstate = jtx.init(jax.tree.map(jnp.asarray, params))
    jupdate = jax.jit(jtx.update)
    ttx = grouped_adam(1e-3, eps=1e-7)
    tstate = ttx.init({k: torch.from_numpy(v) for k, v in params.items()})
    for _ in range(5):
        g = _grads(rng, shapes)
        jup, jstate = jupdate(jax.tree.map(jnp.asarray, g), jstate)
        tup, tstate = ttx.update({k: torch.from_numpy(v) for k, v in g.items()}, tstate)
        for k in shapes:
            np.testing.assert_array_equal(tup[k].numpy(), np.asarray(jup[k]), err_msg=k)
    np.testing.assert_array_equal(tstate.mu_big[0].numpy(), np.asarray(jstate.mu_big[0]))
    assert int(tstate.count) == int(jstate.count) == 5


def _row_ids(rng, v):
    """Duplicates, -1 and ids >= V."""
    ids = rng.integers(0, v, size=(4, 9)).astype(np.int32)
    ids[0, :3] = ids[1, :3]
    ids[2, 0], ids[2, 1], ids[3, 4] = -1, v, v + 7
    return ids


def test_row_adam_updates_are_bit_equal_to_jax_over_five_steps():
    v, d = 40, 6
    table, rng = _table(v, d, np.float32, seed=5)
    jf = jax.jit(lambda s, g, i: jrow.fused_row_adam_update(s, g, i, learning_rate=1e-3))
    jr = jax.jit(lambda t, s, g, i: jrow.row_adam_update(t, s, g, i, learning_rate=1e-3))
    jfs, jrt, jrs = jrow.init_fused_row_adam(jnp.asarray(table)), jnp.asarray(table), \
        jrow.init_row_adam(jnp.asarray(table))
    tfs = trow.init_fused_row_adam(torch.from_numpy(table.copy()))
    trt, trs = torch.from_numpy(table.copy()), trow.init_row_adam(torch.from_numpy(table))
    for _ in range(5):
        ids = _row_ids(rng, v)
        g = _grads(rng, {"g": (v, d)})["g"]
        jfs = jf(jfs, jnp.asarray(g), jnp.asarray(ids))
        jrt, jrs = jr(jrt, jrs, jnp.asarray(g), jnp.asarray(ids))
        tfs = trow.fused_row_adam_update(tfs, torch.from_numpy(g), torch.from_numpy(ids),
                                         learning_rate=1e-3)
        trt, trs = trow.row_adam_update(trt, trs, torch.from_numpy(g), torch.from_numpy(ids),
                                        learning_rate=1e-3)
        np.testing.assert_array_equal(tfs.buf.numpy(), np.asarray(jfs.buf))
        np.testing.assert_array_equal(trt.numpy(), np.asarray(jrt))
        np.testing.assert_array_equal(trs.mu.numpy(), np.asarray(jrs.mu))
        np.testing.assert_array_equal(trs.nu.numpy(), np.asarray(jrs.nu))
    np.testing.assert_array_equal(trow.fused_table(tfs).numpy(), np.asarray(jrow.fused_table(jfs)))

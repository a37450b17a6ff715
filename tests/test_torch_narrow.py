"""Narrow storage and the block shuffle in the port, against the JAX
package.

- `grouped_adam` with `big_moment_dtype` and with `master_weights`,
  over 5 steps on the same gradients, applied as `optax.apply_updates`
  applies them: with masters, moments, masters and params bit-equal.
  With bfloat16 moments on a float32 table (no master), XLA's CPU fusion
  rounds the other product of `b1*mu + (1-b1)*g` first in the first
  moment (one rounding either way; the port's `_fma` keeps the form that
  matches XLA's float32 moments): there the moments agree within one
  bfloat16 ulp and the table within 1e-6 relative + 1e-8 (each step's
  update, about lr = 1e-2, within a few float32 ulps); the small leaves
  stay bit-equal.
- A two-epoch `Trainer` fit with `bf16_table_params` (and bfloat16
  moments) from JAX's narrowed init and JAX's row order: per-epoch loss
  1e-5 relative, AUC 1e-5; the float32 masters within 1e-4 of their
  scale, as `test_torch_training.py` holds float32 params; the bfloat16
  table within one bfloat16 ulp of JAX's (a master a rounding apart may
  round to the neighbouring bfloat16), and within one bfloat16 ulp of
  bf16(master) at max(|p|, |bf16(master)|, 4 lr): the rebase rounds the
  step `bf16(master') - p` to bfloat16, so where a step is large against
  the value the error is an ulp of the step (an Adam step is at most
  about 3.2 lr).
- `bf16_table_params` with `sparse_tables` raises (the JAX package runs
  that combination with bfloat16 row-Adam moments and no master).
- `shuffle_mode="blocks"` with JAX's block order equals JAX's fit at the
  same tolerances (pad rows are zero rows; a sparse table sees id 0 from
  them); when the padded epoch is not whole blocks, the port prints
  JAX's message and trains with the exact shuffle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparrowrecsys_torch.config import TrainConfig
from sparrowrecsys_torch.data.synthetic import synthetic_ctr_dataset
from sparrowrecsys_torch.models import build_model
from sparrowrecsys_torch.training.checkpoint import params_from_flax, params_to_flax
from sparrowrecsys_torch.training.loop import Trainer
from sparrowrecsys_torch.training.optim import grouped_adam
from sparrowrecsys_tpu.config import TrainConfig as JaxTrainConfig
from sparrowrecsys_tpu.data.dataset import EncodedDataset as JaxEncodedDataset
from sparrowrecsys_tpu.models import build_model as jax_build
from sparrowrecsys_tpu.training.loop import Trainer as JaxTrainer
from sparrowrecsys_tpu.training.optim import grouped_adam as jax_grouped_adam

torch.set_num_threads(2)

SEED = 42
SMALL = dict(dim=4, deep_hidden=8)


def _to_torch(x):
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("moments,masters,table", [
    ("bfloat16", False, "float32"),
    (None, True, "bfloat16"),
    ("bfloat16", True, "bfloat16"),
], ids=["bf16_moments", "masters", "masters_bf16_moments"])
def test_grouped_adam_narrow_is_bit_equal_to_jax(moments, masters, table):
    rng = np.random.default_rng(0)
    # Keys in JAX's flattening order, so the fused vectors line up.
    shapes = {"a.kernel": (30, 7), "b.bias": (5,), "emb.table": (70000, 3)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jparams = {"a": {"kernel": jnp.asarray(init["a.kernel"])},
               "b": {"bias": jnp.asarray(init["b.bias"])},
               "emb": {"table": jnp.asarray(init["emb.table"]).astype(table)}}
    jtx = jax_grouped_adam(1e-2, eps=1e-7, master_weights=masters,
                           big_moment_dtype=None if moments is None else jnp.dtype(moments))
    jstate = jtx.init(jparams)

    @jax.jit
    def jstep(p, s, g):
        u, s = jtx.update(g, s, p)
        return optax.apply_updates(p, u), s

    tparams = {k: _to_torch(v) for k, v in
               (("a.kernel", jparams["a"]["kernel"]), ("b.bias", jparams["b"]["bias"]),
                ("emb.table", jparams["emb"]["table"]))}
    ttx = grouped_adam(1e-2, eps=1e-7, master_weights=masters,
                       big_moment_dtype=None if moments is None else getattr(torch, moments))
    tstate = ttx.init(tparams)
    for _ in range(5):
        g = {k: (rng.normal(size=s) * 0.1).astype(np.float32) for k, s in shapes.items()}
        jg = {"a": {"kernel": jnp.asarray(g["a.kernel"])}, "b": {"bias": jnp.asarray(g["b.bias"])},
              "emb": {"table": jnp.asarray(g["emb.table"]).astype(table)}}
        jparams, jstate = jstep(jparams, jstate, jg)
        tg = {k: _to_torch(v) for k, v in
              (("a.kernel", jg["a"]["kernel"]), ("b.bias", jg["b"]["bias"]),
               ("emb.table", jg["emb"]["table"]))}
        updates, tstate = ttx.update(tg, tstate, tparams)
        for k, v in tparams.items():
            v.add_(updates[k])
    table_ref = _to_torch(jparams["emb"]["table"])
    np.testing.assert_array_equal(tparams["a.kernel"].numpy(), np.asarray(jparams["a"]["kernel"]))
    np.testing.assert_array_equal(tstate.mu_vec.numpy(), np.asarray(jstate.mu_vec))
    np.testing.assert_array_equal(tstate.nu_vec.numpy(), np.asarray(jstate.nu_vec))
    moments = ((tstate.mu_big[0], _to_torch(jstate.mu_big[0])),
               (tstate.nu_big[0], _to_torch(jstate.nu_big[0])))
    for got, want in moments:
        assert got.dtype == want.dtype
    if masters:
        np.testing.assert_array_equal(_bits(tparams["emb.table"]), _bits(table_ref))
        for got, want in moments:
            np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        torch.testing.assert_close(tparams["emb.table"], table_ref, rtol=0, atol=2e-4)
        for got, want in moments:
            assert _ulps_bf16(got, want, floor=want.float().abs().max().item()) <= 1
    if masters:
        np.testing.assert_array_equal(tstate.master_big[0].numpy(),
                                      np.asarray(jstate.master_big[0]))
    else:
        assert tstate.master_big == () == jstate.master_big


def _jax_fit(name, cfg, ds, tables=None):
    jt = JaxTrainer(jax_build(name, **SMALL), cfg, sparse_tables=tables)
    jds = JaxEncodedDataset(ds.features, ds.labels)
    init = jax.tree.map(np.array, jt.init_params(jds.features))
    ref = jt.fit(jds, params=jax.tree.map(jnp.asarray, init), verbose=False)
    return init, ref


def _assert_history(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        for k in ("roc_auc", "pr_auc", "accuracy"):
            np.testing.assert_allclose(g[k], w[k], atol=1e-5, err_msg=k)


def _assert_params(got, want):
    want = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    got = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v, np.float32)
           for path, v in jax.tree_util.tree_flatten_with_path(
               jax.tree.map(lambda t: t.float().numpy() if isinstance(t, torch.Tensor) else t,
                            got, is_leaf=lambda t: isinstance(t, torch.Tensor)))[0]}
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(np.abs(w).max(), 1e-3)
        off = int((np.abs(got[k] - w) > 1e-4 * scale).sum())
        assert off == 0, f"{k}: {off} of {w.size} elements beyond 1e-4 of scale {scale}"


def _ulps_bf16(a, b, floor=2.0 ** -126):
    """The largest |a - b| in units of the bfloat16 ulp at
    max(|a|, |b|, floor)."""
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(floor)
    ulp = 2.0 ** (torch.floor(torch.log2(mag)) - 7)
    return ((a - b).abs() / ulp).max().item()


def test_bf16_table_fit_matches_jax():
    ds = synthetic_ctr_dataset(1000, seed=3)
    n, batch = len(ds), 128
    extra = dict(bf16_table_params=True, big_moment_dtype="bfloat16")
    init, ref = _jax_fit("deepfm", JaxTrainConfig(batch_size=batch, epochs=2, seed=SEED, **extra),
                         ds)
    assert init["emb_userId"]["table"].dtype == jnp.bfloat16
    orders = [np.asarray(jax.random.permutation(jax.random.PRNGKey(SEED + e), n))
              for e in range(2)]
    model = build_model("deepfm", **SMALL)
    trainer = Trainer(model, TrainConfig(batch_size=batch, epochs=2, seed=SEED, **extra),
                      device="cpu")
    assert trainer.init_params()["emb_userId.table"].dtype == torch.bfloat16
    assert trainer.init_params()["emb_movieId.table"].dtype == torch.float32
    got = trainer.fit(ds, params=params_from_flax(init, model), orders=orders, verbose=False)
    _assert_history(got.history, ref.history)

    table = got.params["emb_userId.table"]
    assert table.dtype == torch.bfloat16
    master = got.opt_state.master_big[0]
    assert master.dtype == torch.float32 and got.opt_state.mu_big[0].dtype == torch.bfloat16
    assert _ulps_bf16(table, master.bfloat16(), floor=4e-3) <= 1
    ref_table = _to_torch(ref.params["emb_userId"]["table"])
    assert _ulps_bf16(table, ref_table, floor=4e-3) <= 1
    dense = {k: v for k, v in params_to_flax(got.params, model).items() if k != "emb_userId"}
    _assert_params(dense, {k: v for k, v in ref.params.items() if k != "emb_userId"})


def test_bf16_tables_with_sparse_tables_raise():
    cfg = TrainConfig(bf16_table_params=True)
    with pytest.raises(ValueError, match="sparse_tables"):
        Trainer(build_model("deepfm", **SMALL), cfg, sparse_tables={"emb_userId": ("userId",)},
                device="cpu")


def test_block_shuffle_with_jax_block_order_matches_jax():
    ds = synthetic_ctr_dataset(1000, seed=3)
    n, batch, block = len(ds), 64, 128
    tables = {"emb_userId": ("userId",)}
    cfg = dict(batch_size=batch, epochs=2, seed=SEED, shuffle_mode="blocks", shuffle_block=block)
    init, ref = _jax_fit("deepfm", JaxTrainConfig(**cfg), ds, tables)
    padded = -(-n // batch) * batch
    orders = [np.asarray(jax.random.permutation(jax.random.PRNGKey(SEED + e), padded // block))
              for e in range(2)]
    model = build_model("deepfm", **SMALL)
    got = Trainer(model, TrainConfig(**cfg), sparse_tables=tables, device="cpu").fit(
        ds, params=params_from_flax(init, model), orders=orders, verbose=False)
    _assert_history(got.history, ref.history)
    _assert_params(params_to_flax(got.params, model), ref.params)


def test_block_shuffle_falls_back_to_exact_with_jax_message(capsys):
    ds = synthetic_ctr_dataset(500, seed=3)          # padded 512: not whole blocks of 384
    cfg = dict(batch_size=64, epochs=2, seed=SEED, shuffle_block=384)
    JaxTrainer(jax_build("neuralcf"), JaxTrainConfig(shuffle_mode="blocks", **cfg)).fit(
        JaxEncodedDataset(ds.features, ds.labels), epochs=0, verbose=False)
    want = capsys.readouterr().out
    assert "falling back to exact shuffle" in want

    init = Trainer(build_model("neuralcf"), TrainConfig(**cfg), device="cpu").init_params()
    blocks = Trainer(build_model("neuralcf"), TrainConfig(shuffle_mode="blocks", **cfg),
                     device="cpu").fit(ds, params=init, verbose=False)
    assert capsys.readouterr().out == want
    exact = Trainer(build_model("neuralcf"), TrainConfig(**cfg), device="cpu").fit(
        ds, params=init, verbose=False)
    for k in exact.params:
        assert torch.equal(blocks.params[k], exact.params[k]), k

"""Train-state checkpoints in the port (`training/checkpoint.py::
save_train_state`, `load_latest_train_state`; `Trainer.fit(state_dir=,
checkpoint_every=, resume=)`), held against the JAX package's.

- The port's resume is bit-equal to its uninterrupted fit on the CPU,
  for NeuralCF (dense), DeepFMv2 with both tables on the row-Adam, and
  DIEN (a `wants_rng` loss: its per-step generators take the absolute
  epoch).
- JAX -> port: JAX fits one epoch into a state dir, the port resumes it
  with JAX's second-epoch order, and lands on JAX's uninterrupted
  two-epoch fit within `test_torch_training.py`'s tolerances (per-epoch
  loss 1e-5 relative, AUC 1e-5; each parameter 1e-4 of its scale; the
  row buffer 1e-4 relative + 1e-6).
- port -> JAX: JAX's `load_latest_train_state`, with its own templates,
  reads the port's state, every leaf bit-equal to the port's tensors
  after the layout mapping; JAX writing that state again gives the
  port's files byte for byte.
- Cold start, completed epochs skipped, NotATrainStateError on a
  params-only export, checkpoint_every and keep pruning.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as flax_ser

from sparrowrecsys_torch.config import TrainConfig
from sparrowrecsys_torch.data.dataset import EncodedDataset
from sparrowrecsys_torch.data.negatives import add_dien_negatives
from sparrowrecsys_torch.data.synthetic import (
    synthetic_ctr_dataset,
    synthetic_sequence_ctr_dataset,
)
from sparrowrecsys_torch.models import build_model
from sparrowrecsys_torch.models.dien import dien_loss_fn
from sparrowrecsys_torch.training import checkpoint as ckpt
from sparrowrecsys_torch.training.loop import Trainer
from sparrowrecsys_tpu.config import TrainConfig as JaxTrainConfig
from sparrowrecsys_tpu.data.dataset import EncodedDataset as JaxEncodedDataset
from sparrowrecsys_tpu.models import build_model as jax_build
from sparrowrecsys_tpu.training import checkpoint as jax_ckpt
from sparrowrecsys_tpu.training.loop import Trainer as JaxTrainer

torch.set_num_threads(2)

SEED = 42
BOTH = {"emb_userId": ("userId",), "emb_movieId": ("movieId",)}
#: name -> (model kwargs, data, rows, batch, sparse tables, loss)
CASES = {
    "neuralcf": ({}, "ctr", 300, 64, None, None),
    "deepfm_v2_sparse": (dict(dim=4, field_dim=8, deep_hidden=8), "ctr", 300, 64, BOTH, None),
    "dien": (dict(dim=4, hidden=8), "seq", 256, 64, None, "dien"),
}


def _model_name(case):
    return "deepfm_v2" if case.startswith("deepfm_v2") else case


def _data(kind, n):
    if kind == "ctr":
        return synthetic_ctr_dataset(n, seed=3)
    return add_dien_negatives(synthetic_sequence_ctr_dataset(n, seed=5), seed=2020)


def _trainer(case, cfg, model=None):
    kwargs, _, _, _, tables, loss = CASES[case]
    model = model or build_model(_model_name(case), **kwargs)
    return Trainer(model, cfg, sparse_tables=tables,
                   loss_fn=dien_loss_fn() if loss == "dien" else None, device="cpu")


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


def _flat_state(state):
    """A port optimizer state as {path: tensor}."""
    if isinstance(state, dict):
        out = {}
        for k, v in state.items():
            out.update({f"{k}/{p}": t for p, t in _flat_state(v).items()})
        return out
    out = {}
    for field, v in zip(state._fields, state):
        if isinstance(v, (list, tuple)) and not isinstance(v, torch.Tensor):
            out.update({f"{field}/{i}": t for i, t in enumerate(v) if t is not None})
        else:
            out[field] = v
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_resume_is_bit_equal_to_the_uninterrupted_fit(case, tmp_path):
    _, kind, n, batch, _, _ = CASES[case]
    ds = _data(kind, n)
    cfg = TrainConfig(batch_size=batch, epochs=2, seed=SEED, learning_rate=1e-2)
    init = _trainer(case, cfg).init_params()

    full = _trainer(case, cfg).fit(ds, params=init, verbose=False)
    d = str(tmp_path / "state")
    first = _trainer(case, cfg).fit(ds, params=init, epochs=1, state_dir=d, verbose=False)
    resumed = _trainer(case, cfg).fit(ds, state_dir=d, resume=True, verbose=False)

    assert len(first.history) == 1 and len(resumed.history) == 1
    assert resumed.history[0] == full.history[1]
    _assert_same(resumed.params, full.params)
    _assert_same(_flat_state(resumed.opt_state), _flat_state(full.opt_state))
    with open(os.path.join(d, "002", "meta.json")) as f:
        assert json.load(f) == {"next_epoch": 2}


def _jax_flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _state_leaves(tree):
    """A state dict (either package's, as flax writes it) -> {path: array}."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")
        elif node is not None:
            arr = node.float().numpy() if isinstance(node, torch.Tensor) else np.asarray(node)
            out[prefix[:-1]] = arr
    walk(tree, "")
    return out


def test_jax_state_resumes_in_the_port(tmp_path):
    """JAX's first epoch, the port's second: equal to JAX's two epochs."""
    kwargs = CASES["deepfm_v2_sparse"][0]
    ds = synthetic_ctr_dataset(1000, seed=3)
    n, batch = len(ds), 64
    jds = JaxEncodedDataset(ds.features, ds.labels)
    jt = JaxTrainer(jax_build("deepfm_v2", **kwargs),
                    JaxTrainConfig(batch_size=batch, epochs=2, seed=SEED), sparse_tables=BOTH)
    init = jax.tree.map(np.array, jt.init_params(jds.features))
    d = str(tmp_path / "state")
    jt.fit(jds, params=jax.tree.map(jnp.asarray, init), epochs=1, state_dir=d, verbose=False)
    d_full = str(tmp_path / "full")
    ref = jt.fit(jds, params=jax.tree.map(jnp.asarray, init), epochs=2, state_dir=d_full,
                 verbose=False)
    with open(os.path.join(d_full, "002", "opt_state.msgpack"), "rb") as f:
        ref_opt = flax_ser.msgpack_restore(f.read())

    orders = [None, np.asarray(jax.random.permutation(jax.random.PRNGKey(SEED + 1), n))]
    model = build_model("deepfm_v2", **kwargs)
    trainer = Trainer(model, TrainConfig(batch_size=batch, epochs=2, seed=SEED),
                      sparse_tables=BOTH, device="cpu")
    got = trainer.fit(ds, state_dir=str(tmp_path / "state"), resume=True, orders=orders,
                      verbose=False)

    assert len(got.history) == 1
    np.testing.assert_allclose(got.history[0]["loss"], ref.history[1]["loss"], rtol=1e-5)
    for k in ("roc_auc", "pr_auc", "accuracy"):
        np.testing.assert_allclose(got.history[0][k], ref.history[1][k], atol=1e-5, err_msg=k)
    want = _jax_flat(ref.params)
    have = _jax_flat(ckpt.params_to_flax(got.params, model))
    assert set(want) == set(have)
    for k, w in want.items():
        scale = max(np.abs(w).max(), 1e-3)
        off = int((np.abs(have[k] - w) > 1e-4 * scale).sum())
        assert off == 0, f"{k}: {off} of {w.size} elements beyond 1e-4 of scale {scale}"
    for mod in BOTH:
        np.testing.assert_allclose(got.opt_state["rows"][mod].buf.numpy(),
                                   np.asarray(ref_opt["rows"][mod]["buf"]),
                                   rtol=1e-4, atol=1e-6)
        assert int(got.opt_state["rows"][mod].count) == int(ref_opt["rows"][mod]["count"])


@pytest.mark.parametrize("case", ["deepfm_bf16_masters", "deepfm_v2_sparse"])
def test_port_state_resumes_in_jax(case, tmp_path):
    """JAX reads the port's state with its own templates: every leaf equal
    to the port's, bit for bit; JAX re-saving it writes the same bytes."""
    if case == "deepfm_bf16_masters":
        name, kwargs, tables = "deepfm", dict(dim=4, deep_hidden=8), None
        extra = dict(bf16_table_params=True, big_moment_dtype="bfloat16")
    else:
        name, kwargs, tables, extra = "deepfm_v2", CASES[case][0], BOTH, {}
    ds = synthetic_ctr_dataset(300, seed=3)
    model = build_model(name, **kwargs)
    cfg = TrainConfig(batch_size=64, epochs=1, seed=SEED, **extra)
    d = str(tmp_path / "port")
    got = Trainer(model, cfg, sparse_tables=tables, device="cpu").fit(
        ds, state_dir=d, verbose=False)

    jt = JaxTrainer(jax_build(name, **kwargs), JaxTrainConfig(**extra), sparse_tables=tables)
    jparams = jt.init_params(ds.features)
    jopt = jt.init_opt_state(jparams)
    if tables:
        jparams = jt._dense_view(jparams)
    params, opt, next_epoch, meta = jax_ckpt.load_latest_train_state(d, jparams, jopt)
    assert next_epoch == 1 and meta == {"next_epoch": 1}

    port_params = got.params
    if tables:
        port_params = Trainer(model, cfg, sparse_tables=tables, device="cpu")._dense_view(
            got.params)
    want_p = _state_leaves(ckpt.params_to_flax(port_params, model))
    have_p = _state_leaves(flax_ser.to_state_dict(params))
    want_o = _state_leaves(ckpt.opt_state_to_flax(got.opt_state, port_params, model))
    have_o = _state_leaves(flax_ser.to_state_dict(opt))
    for want, have in ((want_p, have_p), (want_o, have_o)):
        assert set(want) == set(have)
        for k in want:
            assert want[k].shape == have[k].shape, k
            np.testing.assert_array_equal(have[k].astype(np.float64),
                                          want[k].astype(np.float64), err_msg=k)
    if case == "deepfm_bf16_masters":
        assert opt.master_big[0].dtype == jnp.float32 and opt.mu_big[0].dtype == jnp.bfloat16
        assert params["emb_userId"]["table"].dtype == jnp.bfloat16

    # Re-flattened as the JAX trainer's own state is (sorted dict keys).
    params, opt = jax.tree.map(lambda x: x, (params, opt))
    d2 = str(tmp_path / "jax")
    jax_ckpt.save_train_state(params, opt, next_epoch, d2)
    for f in ("params.msgpack", "opt_state.msgpack", "meta.json"):
        with open(os.path.join(d, "001", f), "rb") as a, open(os.path.join(d2, "001", f), "rb") as b:
            assert a.read() == b.read(), f


def _neuralcf(cfg):
    return Trainer(build_model("neuralcf"), cfg, device="cpu")


def test_resume_without_a_state_starts_cold(tmp_path):
    ds = synthetic_ctr_dataset(200, seed=3)
    cfg = TrainConfig(batch_size=64, epochs=2, seed=SEED)
    init = _neuralcf(cfg).init_params()
    cold = _neuralcf(cfg).fit(ds, params=init, state_dir=str(tmp_path / "none"), resume=True,
                              verbose=False)
    plain = _neuralcf(cfg).fit(ds, params=init, verbose=False)
    assert len(cold.history) == 2
    _assert_same(cold.params, plain.params)


def test_resume_skips_completed_epochs(tmp_path):
    ds = synthetic_ctr_dataset(200, seed=3)
    cfg = TrainConfig(batch_size=64, epochs=2, seed=SEED)
    d = str(tmp_path / "state")
    done = _neuralcf(cfg).fit(ds, state_dir=d, verbose=False)
    again = _neuralcf(cfg).fit(ds, state_dir=d, resume=True, verbose=False)
    assert again.history == []
    _assert_same(again.params, done.params)


def test_resume_from_a_params_only_export_raises(tmp_path):
    ds = synthetic_ctr_dataset(200, seed=3)
    cfg = TrainConfig(batch_size=64, epochs=1, seed=SEED)
    trainer = _neuralcf(cfg)
    d = str(tmp_path / "export")
    ckpt.save(ckpt.params_to_flax(trainer.init_params(), trainer.model), d)
    with pytest.raises(ckpt.NotATrainStateError):
        _neuralcf(cfg).fit(ds, state_dir=d, resume=True, verbose=False)


@pytest.mark.parametrize("every,keep,want", [(2, 5, {1: 2, 2: 3}), (1, 2, {2: 2, 3: 3})],
                         ids=["checkpoint_every", "keep"])
def test_checkpoint_every_and_keep(every, keep, want, tmp_path):
    ds = synthetic_ctr_dataset(200, seed=3)
    cfg = TrainConfig(batch_size=64, epochs=3, seed=SEED, checkpoint_keep=keep)
    d = str(tmp_path / "state")
    _neuralcf(cfg).fit(ds, state_dir=d, checkpoint_every=every, verbose=False)
    have = {}
    for v in sorted(os.listdir(d)):
        with open(os.path.join(d, v, "meta.json")) as f:
            have[int(v)] = json.load(f)["next_epoch"]
        assert os.path.exists(os.path.join(d, v, "opt_state.msgpack"))
    assert have == want


def test_block_shuffle_resume_is_bit_equal(tmp_path):
    """The block order of epoch e depends on e alone, as the exact order."""
    ds = synthetic_ctr_dataset(500, seed=3)
    cfg = TrainConfig(batch_size=64, epochs=2, seed=SEED, shuffle_mode="blocks",
                      shuffle_block=32)
    init = _neuralcf(cfg).init_params()
    full = _neuralcf(cfg).fit(ds, params=init, verbose=False)
    d = str(tmp_path / "state")
    _neuralcf(cfg).fit(ds, params=init, epochs=1, state_dir=d, verbose=False)
    resumed = _neuralcf(cfg).fit(ds, state_dir=d, resume=True, verbose=False)
    _assert_same(resumed.params, full.params)

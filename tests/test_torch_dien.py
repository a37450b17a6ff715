"""DIEN in the port against the JAX package on the CPU: logits and aux in
all three `aux_mode`s and under narrow dtypes, every parameter's gradient
of `dien_loss_fn`, the loss itself, the merged gather, the negatives
(from the data, bit-equal to JAX's, and in the step), the recurrences'
`custom_vjp` and `remat` inside the model, and two-epoch fits against the
JAX Trainer, with and without a lazy row-Adam user table. The gradients
and the fits run a second time on the card's path, the recurrences in
`_GRUKernel` and `_AUGRUKernel`, whose wrappers take the kernels' twins
for CPU tensors.

Tolerances: logits and aux within 1e-5 of their largest value; each
gradient within 1e-4 of its scale; fits as `test_torch_training.py`
holds them (the JAX order and the same negative columns are injected)."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparrowrecsys_torch.config import TrainConfig
from sparrowrecsys_torch.data.negatives import add_dien_negatives
from sparrowrecsys_torch.data.synthetic import synthetic_sequence_ctr_dataset
from sparrowrecsys_torch.models import build_model as torch_build
from sparrowrecsys_torch.models.dien import (
    NEGATIVE_COLS,
    dien_loss_fn,
    negative_cols,
    sample_negatives_in_graph,
)
from sparrowrecsys_torch.ops import augru as A
from sparrowrecsys_torch.training.checkpoint import params_from_flax, params_to_flax
from sparrowrecsys_torch.training.loop import Trainer
from sparrowrecsys_tpu.config import TrainConfig as JaxTrainConfig
from sparrowrecsys_tpu.data.dataset import EncodedDataset as JaxEncodedDataset
from sparrowrecsys_tpu.data.negatives import add_dien_negatives as jax_add_dien_negatives
from sparrowrecsys_tpu.models import build_model as jax_build
from sparrowrecsys_tpu.models.dien import dien_loss_fn as jax_dien_loss_fn
from sparrowrecsys_tpu.models.dien import negative_cols as jax_negative_cols
from sparrowrecsys_tpu.training.loop import Trainer as JaxTrainer
from tests.test_torch_models import _features, _perturb
from tests.test_torch_training import EPOCHS, SEED, _flat, _jax_epochs
from tests.test_torch_zoo import _with_negatives, assert_fit_close

torch.set_num_threads(2)

SMALL = dict(dim=4, hidden=8, movie_buckets=50, user_buckets=60)
MODES = {"reference": {}, "paper": {"aux_mode": "paper"},
         "paper_mean": {"aux_mode": "paper", "aux_norm": "mean"},
         "none": {"aux_mode": "none"}}


def _case(seed, n=12, **kwargs):
    """(model kwargs, JAX-initialised perturbed tree, features, labels)."""
    rng = np.random.default_rng(seed)
    kwargs = {**SMALL, **kwargs}
    feats = _with_negatives(_features(n, rng), rng)
    init = jax_build("dien", **kwargs).init(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in feats.items()})["params"]
    labels = (rng.random(n) < 0.5).astype(np.float32)
    return kwargs, _perturb(init, rng), feats, labels


def _torch_model(kwargs, tree):
    model = torch_build("dien", **kwargs)
    model.load_state_dict(params_from_flax(tree, model))
    return model


def _tensors(feats):
    return {k: torch.from_numpy(v) for k, v in feats.items()}


def _close(got, ref, rel, what=""):
    ref = np.asarray(ref)
    scale = max(np.abs(ref).max(), 1e-6)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=rel * scale, err_msg=what)


@pytest.mark.parametrize("mode", MODES)
def test_logits_aux_loss_and_gradients_match_jax(mode):
    kwargs, tree, feats, labels = _case(0, **MODES[mode])
    aux_mode = kwargs.get("aux_mode", "reference")
    jmodel = jax_build("dien", **kwargs)
    jloss = jax_dien_loss_fn(aux_mode=aux_mode)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    ones = jnp.ones(len(labels))
    (ref_loss, (_, ref_sum)), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: jloss(jmodel.apply, p, jfeats, jnp.asarray(labels), ones),
        has_aux=True))(jax.tree.map(jnp.asarray, tree))
    ref_logits, ref_aux = jmodel.apply({"params": tree}, jfeats)

    model = _torch_model(kwargs, tree)
    with torch.no_grad():
        logits, aux = model(_tensors(feats))
    _close(logits, ref_logits, 1e-5, "logits")
    _close(aux, ref_aux, 1e-5, "aux")
    if aux_mode == "none":
        assert not aux.any() and not any(k.startswith("aux_") for k in model.state_dict())

    trainer = Trainer(model, loss_fn=dien_loss_fn(aux_mode=aux_mode), device="cpu")
    tl = torch.from_numpy(labels)
    _, loss, loss_sum, grads = trainer.loss_and_grads(
        dict(model.state_dict()), None, _tensors(feats), tl, torch.ones_like(tl))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(loss_sum.item(), float(ref_sum), rtol=1e-5)
    got, ref = _flat(params_to_flax(grads, model)), _flat(ref_grads)
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], 1e-4, k)


@pytest.mark.parametrize("dtypes", [{"lookup_dtype": "bfloat16"}, {"compute_dtype": "bfloat16"}],
                         ids=["bf16_lookup", "bf16_towers"])
def test_narrow_dtypes_round_where_jax_rounds(dtypes):
    """bf16 tables before the gather or bf16 towers move the logits by
    1e-4 or more from float32; the recurrences stay float32 in both."""
    kwargs, tree, feats, _ = _case(1, n=32, **dtypes)
    ref_logits, ref_aux = jax_build("dien", **kwargs).apply(
        {"params": tree}, {k: jnp.asarray(v) for k, v in feats.items()})
    with torch.no_grad():
        logits, aux = _torch_model(kwargs, tree)(_tensors(feats))
    assert logits.dtype == aux.dtype == torch.float32
    _close(logits, ref_logits, 1e-5, "logits")
    _close(aux, ref_aux, 1e-5, "aux")


@pytest.mark.parametrize("aux_mode", ["reference", "none"])
def test_merged_gather_is_bit_identical_to_three_gathers(aux_mode):
    _, tree, feats, _ = _case(2, n=32, aux_mode=aux_mode)
    outs = []
    for merged in (False, True):
        model = _torch_model({**SMALL, "aux_mode": aux_mode, "merged_gather": merged}, tree)
        with torch.no_grad():
            outs.append(model(_tensors(feats)))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.parametrize("recurrence", [{"recurrence_custom_vjp": True},
                                        {"recurrence_remat": True}],
                         ids=["custom_vjp", "remat"])
def test_recurrence_paths_inside_the_model_give_the_autodiff_gradients(recurrence):
    kwargs, tree, feats, labels = _case(3)
    tl = torch.from_numpy(labels)
    grads = []
    for extra in ({}, recurrence):
        model = _torch_model({**kwargs, **extra}, tree)
        trainer = Trainer(model, loss_fn=dien_loss_fn(), device="cpu")
        grads.append(trainer.loss_and_grads(dict(model.state_dict()), None, _tensors(feats),
                                            tl, torch.ones_like(tl))[3])
    for k, ref in grads[0].items():
        _close(grads[1][k], ref, 1e-5, k)


def test_aux_norm_mean_with_the_reference_aux_raises():
    with pytest.raises(ValueError, match="aux_norm='mean'"):
        torch_build("dien", aux_norm="mean")
    with pytest.raises(ValueError, match="aux_mode"):
        torch_build("dien", aux_mode="nope")


def test_add_dien_negatives_is_bit_equal_to_jax():
    ds = synthetic_sequence_ctr_dataset(3000, seed=7)
    for seed in (2020, 2021):
        got = add_dien_negatives(ds, seed=seed)
        ref = jax_add_dien_negatives(JaxEncodedDataset(ds.features, ds.labels), seed=seed)
        assert set(got.features) == set(ref.features) == set(ds.features) | set(NEGATIVE_COLS)
        for c in NEGATIVE_COLS:
            assert got.features[c].dtype == np.int32
            assert np.array_equal(got.features[c], ref.features[c]), c
            pos = ds.features[c.replace("negative", "").replace("User", "user")]
            assert not np.any(got.features[c] == pos)
    assert negative_cols(7) == jax_negative_cols(7)


def test_in_graph_negatives_are_in_range_and_never_the_positive():
    rng = np.random.default_rng(8)
    feats = {f"userRatedMovie{k}": torch.from_numpy(rng.integers(0, 11, 4000).astype(np.int32))
             for k in range(1, 6)}
    out = sample_negatives_in_graph(torch.Generator().manual_seed(3), feats, 5, movie_vocab=11)
    for k, c in zip(range(2, 6), NEGATIVE_COLS):
        neg, pos = out[c], feats[f"userRatedMovie{k}"]
        assert neg.dtype == torch.int32 and neg.min() >= 0 and neg.max() <= 10
        assert not (neg == pos).any()
        assert len(torch.unique(neg)) == 11            # every id is drawn somewhere
    again = sample_negatives_in_graph(torch.Generator().manual_seed(3), feats, 5, 11)
    assert all(torch.equal(out[c], again[c]) for c in NEGATIVE_COLS)


def test_trainer_draws_in_graph_negatives_from_a_seeded_step_generator():
    """`wants_rng`: the training data carries no negative columns; the
    Trainer hands the loss a generator per step, so a fit is repeatable
    and moves the aux heads."""
    ds = synthetic_sequence_ctr_dataset(256, seed=9)
    loss = dien_loss_fn(in_graph_negatives=True)
    assert loss.wants_rng and set(NEGATIVE_COLS) <= set(
        loss.prepare_init_features(_tensors(ds.features)))
    results = []
    for _ in range(2):
        model = torch_build("dien", dim=4, hidden=8)
        trainer = Trainer(model, TrainConfig(batch_size=64, epochs=1, seed=1), loss_fn=loss,
                          device="cpu")
        results.append(trainer.fit(ds, verbose=False))
    init = trainer.init_params()
    for k, v in results[0].params.items():
        assert torch.equal(v, results[1].params[k]), k
    assert not torch.equal(results[0].params["aux_neg32.weight"], init["aux_neg32.weight"])
    g1, g2 = trainer.step_generator(0, 0), trainer.step_generator(0, 1)
    assert not torch.equal(torch.rand(4, generator=g1), torch.rand(4, generator=g2))


@pytest.mark.parametrize("n,batch,sparse", [(512, 128, False), (500, 64, True)],
                         ids=["dense", "sparse_user_table_padded"])
def test_two_epoch_fit_matches_jax(n, batch, sparse):
    ds = add_dien_negatives(synthetic_sequence_ctr_dataset(n, seed=5), seed=2020)
    jds = JaxEncodedDataset(ds.features, ds.labels)
    kwargs = dict(dim=4, hidden=8)
    tables = {"emb_userId": ("userId",)} if sparse else None
    jt = JaxTrainer(jax_build("dien", **kwargs),
                    JaxTrainConfig(batch_size=batch, epochs=EPOCHS, seed=SEED, learning_rate=1e-2),
                    loss_fn=jax_dien_loss_fn(), sparse_tables=tables)
    init = jax.tree.map(lambda a: np.array(a), jt.init_params(jds.features))
    orders = [np.asarray(jax.random.permutation(jax.random.PRNGKey(SEED + e), n))
              for e in range(EPOCHS)]
    model = torch_build("dien", **kwargs)
    trainer = Trainer(model, TrainConfig(batch_size=batch, epochs=EPOCHS, seed=SEED,
                                         learning_rate=1e-2),
                      loss_fn=dien_loss_fn(), sparse_tables=tables, device="cpu")
    result = trainer.fit(ds, params=params_from_flax(init, model), orders=orders,
                         verbose=False)
    if sparse:
        ref_params, ref_opt, ref_history = _jax_epochs(jt, jax.tree.map(jnp.asarray, init),
                                                       jds, batch)
        np.testing.assert_allclose(result.opt_state["rows"]["emb_userId"].buf.numpy(),
                                   np.asarray(ref_opt["rows"]["emb_userId"].buf),
                                   rtol=1e-4, atol=1e-6)
    else:
        ref = jt.fit(jds, params=jax.tree.map(jnp.asarray, init), verbose=False)
        ref_params, ref_history = ref.params, ref.history
    assert_fit_close(result, ref_history, ref_params, init, model)
    assert set(_flat(params_to_flax(result.params, model))) == set(_flat(ref_params))


TWINS = ("gru_scan_fwd_plain", "gru_scan_bwd_plain", "augru_scan_fwd_plain",
         "augru_scan_bwd_plain")


@pytest.fixture
def kernels_path(monkeypatch):
    """The recurrences on the card's path, on the CPU: the kernels' twins,
    each call counted."""
    calls = collections.Counter()
    monkeypatch.setattr(A, "_KERNEL_DEVICES", ("cuda", "cpu"))
    for name in TWINS:
        def counted(*args, _real=getattr(A, name), _name=name):
            calls[_name] += 1
            return _real(*args)
        monkeypatch.setattr(A, name, counted)
    return calls


@pytest.mark.parametrize("mode", MODES)
def test_logits_aux_loss_and_gradients_match_jax_on_the_kernels_path(mode, kernels_path):
    test_logits_aux_loss_and_gradients_match_jax(mode)
    assert all(kernels_path[n] for n in TWINS), kernels_path


@pytest.mark.parametrize("n,batch,sparse", [(512, 128, False), (500, 64, True)],
                         ids=["dense", "sparse_user_table_padded"])
def test_two_epoch_fit_matches_jax_on_the_kernels_path(n, batch, sparse, kernels_path):
    test_two_epoch_fit_matches_jax(n, batch, sparse)
    assert all(kernels_path[n] for n in TWINS), kernels_path

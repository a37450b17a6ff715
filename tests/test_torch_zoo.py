"""EmbeddingMLP, Wide&Deep, NeuralCF and its two-tower (and, for the
exports and serving, DIEN) in the port against the JAX zoo on the CPU:
logits and gradients from the same JAX-initialised weights, the
crossed-column hash bit for bit, the five shipped exports on
testSamples.csv, a port-written export in the JAX model, two-epoch fits
against the JAX Trainer, and ranking through both servers.

Tolerances: logits within 1e-5 of the largest logit (float32 in another
summation order, `assert_logits_close`); each parameter's gradient
within 1e-4 of that gradient's scale; fits as `test_torch_training.py`
holds them."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparrowrecsys_torch.config import ServingConfig as TServingConfig
from sparrowrecsys_torch.config import TrainConfig
from sparrowrecsys_torch.data.dataset import EncodedDataset
from sparrowrecsys_torch.data.negatives import add_dien_negatives
from sparrowrecsys_torch.data.synthetic import synthetic_ctr_dataset
from sparrowrecsys_torch.models import MODEL_REGISTRY, build_model as torch_build
from sparrowrecsys_torch.models.dien import NEGATIVE_COLS
from sparrowrecsys_torch.models.wide_deep import cross_hash
from sparrowrecsys_torch.serving.assembler import FeatureAssembler as TAssembler
from sparrowrecsys_torch.serving.catalog import DataManager as TDataManager
from sparrowrecsys_torch.serving.feature_store import FeatureStore as TStore
from sparrowrecsys_torch.serving.rankers import ModelScorer as TScorer
from sparrowrecsys_torch.serving.server import RecSysServer as TServer, server_from_args
from sparrowrecsys_torch.training.checkpoint import (
    load_latest,
    params_from_flax,
    params_to_flax,
    save,
)
from sparrowrecsys_torch.training.loop import Trainer
from sparrowrecsys_tpu.config import ServingConfig as JServingConfig
from sparrowrecsys_tpu.config import TrainConfig as JaxTrainConfig
from sparrowrecsys_tpu.data.dataset import EncodedDataset as JaxEncodedDataset
from sparrowrecsys_tpu.data.dataset import encode_samples, load_samples_csv
from sparrowrecsys_tpu.models import build_model as jax_build
from sparrowrecsys_tpu.models.wide_deep import cross_hash as jax_cross_hash
from sparrowrecsys_tpu.serving.assembler import FeatureAssembler as JAssembler
from sparrowrecsys_tpu.serving.catalog import DataManager as JDataManager
from sparrowrecsys_tpu.serving.feature_store import FeatureStore as JStore
from sparrowrecsys_tpu.serving.rankers import ModelScorer as JScorer
from sparrowrecsys_tpu.serving.server import RecSysServer as JServer
from sparrowrecsys_tpu.training import checkpoint as jax_ckpt
from sparrowrecsys_tpu.training.loop import Trainer as JaxTrainer
from tests.test_torch_models import _features, _perturb, assert_logits_close
from tests.test_torch_training import EPOCHS, SEED, _flat

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")
ZOO = ("embedding_mlp", "wide_deep", "neuralcf", "neuralcf_two_tower")
SMALL = {
    "embedding_mlp": dict(dim=4, hidden=8, movie_buckets=50, user_buckets=60),
    "wide_deep": dict(dim=4, hidden=8, movie_buckets=50, user_buckets=60, cross_buckets=97),
    "neuralcf": dict(dim=4, hidden=(8, 6), movie_buckets=50, user_buckets=60),
    "neuralcf_two_tower": dict(dim=4, hidden=(8, 6), movie_buckets=50, user_buckets=60),
    "dien": dict(dim=4, hidden=8, movie_buckets=50, user_buckets=60),
}
#: The exports the five new models ship with, and the users ranked.
EXPORTS = ("embedding_mlp", "wide_deep", "neuralcf", "neuralcf_two_tower", "dien")
USERS = (14887, 11888, 2)
TIE_TOL = 1e-6


def _with_negatives(feats, rng, buckets=50):
    return dict(feats, **{c: rng.integers(0, buckets, len(feats["movieId"])).astype(np.int32)
                          for c in NEGATIVE_COLS})


def _jax_init(name, kwargs, feats):
    return jax_build(name, **kwargs).init(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in feats.items()})["params"]


def _torch_out(name, kwargs, tree, feats):
    model = torch_build(name, **kwargs)
    model.load_state_dict(params_from_flax(tree, model))
    with torch.no_grad():
        out = model({k: torch.from_numpy(v) for k, v in feats.items()})
    return out[0].numpy() if isinstance(out, tuple) else out.numpy()


def _jax_out(name, kwargs, tree, feats):
    out = jax_build(name, **kwargs).apply({"params": tree},
                                          {k: jnp.asarray(v) for k, v in feats.items()})
    return np.asarray(out[0] if isinstance(out, tuple) else out)


def test_registry_builds_all_eight_zoo_models():
    assert sorted(MODEL_REGISTRY) == sorted(
        ZOO + ("deepfm", "deepfm_v2", "din", "dien"))
    for name in MODEL_REGISTRY:
        assert isinstance(torch_build(name), torch.nn.Module)
    with pytest.raises(KeyError):
        torch_build("no_such_model")


@pytest.mark.parametrize("dtypes", [
    {}, {"lookup_dtype": "bfloat16"}, {"compute_dtype": "bfloat16"},
], ids=["float32", "bf16_lookup", "bf16_towers"])
@pytest.mark.parametrize("name", ["embedding_mlp", "wide_deep"])
def test_small_models_match_jax_with_dtypes(name, dtypes):
    rng = np.random.default_rng(1)
    kwargs = {**SMALL[name], **dtypes}
    feats = _features(64, rng)
    tree = _perturb(_jax_init(name, kwargs, feats), rng)
    np.testing.assert_allclose(_torch_out(name, kwargs, tree, feats),
                               _jax_out(name, kwargs, tree, feats), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ZOO)
def test_small_models_match_jax_logits_and_gradients(name):
    rng = np.random.default_rng(2)
    kwargs = SMALL[name]
    feats = _features(64, rng)
    labels = (rng.random(64) < 0.4).astype(np.float32)
    tree = _perturb(_jax_init(name, kwargs, feats), rng)
    got, ref = _torch_out(name, kwargs, tree, feats), _jax_out(name, kwargs, tree, feats)
    assert got.shape == (64,)
    assert_logits_close(got, ref)
    _assert_grads_close(name, kwargs, tree, feats, labels)


def _assert_grads_close(name, kwargs, tree, feats, labels):
    """Every parameter's gradient of the mean BCE within 1e-4 of its scale."""
    import optax

    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    jmodel = jax_build(name, **kwargs)

    def jl(p):
        return optax.sigmoid_binary_cross_entropy(
            jmodel.apply({"params": p}, jfeats), jnp.asarray(labels)).mean()

    ref = _flat(jax.jit(jax.grad(jl))(jax.tree.map(jnp.asarray, tree)))
    model = torch_build(name, **kwargs)
    trainer = Trainer(model, device="cpu")
    params = dict(params_from_flax(tree, model))
    tf = {k: torch.from_numpy(v) for k, v in feats.items()}
    tl = torch.from_numpy(labels)
    _, _, _, grads = trainer.loss_and_grads(params, None, tf, tl, torch.ones_like(tl))
    got = _flat(params_to_flax(grads, model))
    assert set(got) == set(ref)
    for k, r in ref.items():
        scale = max(np.abs(r).max(), 1e-6)
        np.testing.assert_allclose(got[k], r, rtol=0, atol=1e-4 * scale, err_msg=k)


@pytest.mark.parametrize("ids", [
    "edges",
    "random",
])
def test_cross_hash_is_bit_equal_to_jax(ids):
    rng = np.random.default_rng(3)
    if ids == "edges":
        edge = np.array([-1, 0, 1, 2 ** 31 - 1, -(2 ** 31), 1000, 30000], np.int32)
        a, b = np.repeat(edge, len(edge)), np.tile(edge, len(edge))
    else:
        a = rng.integers(-(2 ** 31), 2 ** 31, 5000, dtype=np.int64).astype(np.int32)
        b = rng.integers(-1, 1001, 5000).astype(np.int32)
    for buckets in (10000, 97, 1):
        ref = np.asarray(jax_cross_hash(jnp.asarray(a), jnp.asarray(b), buckets))
        got = cross_hash(torch.from_numpy(a), torch.from_numpy(b), buckets).numpy()
        assert got.dtype == np.int32 and np.array_equal(got, ref), buckets


def _test_samples(name):
    path = os.path.join(DATA, "testSamples.csv")
    ds = encode_samples(load_samples_csv(path))
    if name == "dien":
        ds = add_dien_negatives(EncodedDataset(ds.features, ds.labels), seed=2021)
    return {k: v[:256] for k, v in ds.features.items()}


@pytest.mark.parametrize("name", EXPORTS)
def test_shipped_exports_match_jax_on_test_samples(name):
    feats = _test_samples(name)
    tree, _, _ = load_latest(os.path.join(DATA, "modeldata", name))
    got, ref = _torch_out(name, {}, tree, feats), _jax_out(name, {}, tree, feats)
    assert got.shape == (256,) and np.isfinite(got).all()
    assert_logits_close(got, ref)


@pytest.mark.parametrize("name", EXPORTS)
def test_port_export_loads_into_the_jax_model(name, tmp_path):
    kwargs = SMALL[name]
    model = torch_build(name, **kwargs)
    params = Trainer(model, TrainConfig(seed=5), device="cpu").init_params()
    vdir = save(params_to_flax(params, model), str(tmp_path), meta={"model": name})
    rng = np.random.default_rng(4)
    feats = _with_negatives(_features(32, rng), rng)
    restored, version, meta = jax_ckpt.load_latest(str(tmp_path), _jax_init(name, kwargs, feats))
    assert version == 1 and meta == {"model": name} and vdir.endswith("001")
    tree = jax.tree.map(np.asarray, restored)
    model.load_state_dict(params)
    with torch.no_grad():
        out = model({k: torch.from_numpy(v) for k, v in feats.items()})
    got = (out[0] if isinstance(out, tuple) else out).numpy()
    np.testing.assert_allclose(got, _jax_out(name, kwargs, tree, feats), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", EXPORTS)
def test_init_params_have_the_flax_layout_and_distributions(name):
    """Names and shapes of the flax tree; kernels lecun-normal (bounded
    at 2 / 0.8796 standard units), `gru_recurrent` orthogonal (its rows
    orthonormal), tables within 0.05, the rest 0."""
    model = torch_build(name)
    params = Trainer(model, device="cpu").init_params()
    rng = np.random.default_rng(0)
    feats = _with_negatives(_features(2, rng), rng)
    ref = _flat(_jax_init(name, {}, feats))
    got = _flat(params_to_flax(params, model))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in ref.items()}
    raw = set(getattr(model, "RAW_KERNELS", ()))
    for key, v in params.items():
        mod, _, leaf = key.rpartition(".")
        if key in getattr(model, "ORTHOGONAL_KERNELS", ()):
            np.testing.assert_allclose(v @ v.T, torch.eye(v.shape[0]), atol=1e-5)
        elif leaf == "table":
            assert v.abs().max() <= 0.05 and v.std() > 0.02, key
        elif leaf == "weight" or key in raw:
            fan_in = v.shape[1] if leaf == "weight" else v.shape[0]
            assert v.abs().max() <= 2 / 0.8796256610342398 / fan_in ** 0.5 + 1e-6, key
            assert v.abs().max() > 0, key
        else:
            assert not v.any(), key


@pytest.mark.parametrize("name", ZOO)
def test_two_epoch_fit_matches_jax(name):
    n, batch = 1024, 128
    ds = synthetic_ctr_dataset(n, seed=3)
    jds = JaxEncodedDataset(ds.features, ds.labels)
    kwargs = {k: v for k, v in SMALL[name].items() if not k.endswith("buckets")}
    jt = JaxTrainer(jax_build(name, **kwargs),
                    JaxTrainConfig(batch_size=batch, epochs=EPOCHS, seed=SEED))
    init = jax.tree.map(lambda a: np.array(a), jt.init_params(jds.features))
    orders = [np.asarray(jax.random.permutation(jax.random.PRNGKey(SEED + e), n))
              for e in range(EPOCHS)]
    model = torch_build(name, **kwargs)
    trainer = Trainer(model, TrainConfig(batch_size=batch, epochs=EPOCHS, seed=SEED),
                      device="cpu")
    result = trainer.fit(ds, params=params_from_flax(init, model), orders=orders,
                         verbose=False)
    ref = jt.fit(jds, params=jax.tree.map(jnp.asarray, init), verbose=False)
    assert_fit_close(result, ref.history, ref.params, init, model)


def assert_fit_close(result, ref_history, ref_params, init, model):
    """Per-epoch loss 1e-5 relative and streaming metrics 1e-5; final
    parameters within 1e-4 of each leaf's scale; the weights moved."""
    assert len(result.history) == len(ref_history)
    for got, want in zip(result.history, ref_history):
        np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=1e-5)
        for k in ("roc_auc", "pr_auc", "accuracy"):
            np.testing.assert_allclose(got[k], float(want[k]), atol=1e-5, err_msg=k)
    got, want = _flat(params_to_flax(result.params, model)), _flat(ref_params)
    assert set(got) == set(want)
    for k, ref_leaf in want.items():
        scale = max(np.abs(ref_leaf).max(), 1e-3)
        off = int((np.abs(got[k] - ref_leaf) > 1e-4 * scale).sum())
        assert off == 0, f"{k}: {off} of {ref_leaf.size} elements beyond 1e-4 of scale {scale}"
    assert any(np.abs(want[k] - _flat(init)[k]).max() > 1e-4 for k in want)


# ---- serving ------------------------------------------------------------------


def _files():
    return (f"{DATA}/movies.csv", f"{DATA}/links.csv", f"{DATA}/ratings.csv",
            f"{DATA}/modeldata/item2vecEmb.csv", f"{DATA}/modeldata/userEmb.csv")


RANKED = ("embedding_mlp", "wide_deep", "neuralcf_two_tower", "dien")


@pytest.fixture(scope="module")
def servers():
    """A JAX and a port server over the same files: the four feature
    models as named scorers (DIEN with its zero negative columns) and
    NeuralCF as the id-only scorer."""
    jdm = JDataManager().load_data(*_files())
    tdm = TDataManager().load_data(*_files())
    jasm = JAssembler(JStore.load(f"{DATA}/feature_store.json"), jdm)
    tasm = TAssembler(TStore.load(f"{DATA}/feature_store.json"), tdm)

    def extra(m):
        return NEGATIVE_COLS if m == "dien" else ()

    jscorers = {m: JScorer.from_checkpoint(jax_build(m), f"{DATA}/modeldata/{m}",
                                           assembler=jasm, extra_int_cols=extra(m))
                for m in RANKED}
    tscorers = {m: TScorer.from_checkpoint(torch_build(m), f"{DATA}/modeldata/{m}", tasm,
                                           device="cpu", extra_int_cols=extra(m))
                for m in RANKED}
    ncf = f"{DATA}/modeldata/neuralcf"
    jserver = JServer(jdm, JServingConfig(port=0, model_batch=2, model_poll_s=0),
                      scorer=JScorer.from_checkpoint(jax_build("neuralcf"), ncf),
                      scorers=jscorers)
    tserver = TServer(tdm, TServingConfig(port=0, model_batch=2, model_poll_s=0),
                      scorers=tscorers, device="cpu",
                      scorer=TScorer.from_checkpoint(torch_build("neuralcf"), ncf, device="cpu"))
    return jserver, tserver


def _get(server, path, **params):
    status, _, body = server.handle(path, lambda k, d="": str(params.get(k, d)))
    assert status == 200
    return body


def _ids(body):
    return [m["movieId"] for m in json.loads(body)]


def _assert_same_order(got, ref, ref_score):
    """`got` holds `ref`'s movies and inverts no pair whose reference
    scores differ by 2 * TIE_TOL or more."""
    assert sorted(got) == sorted(ref)
    score = np.array([ref_score[m] for m in got])
    bad = np.argwhere(np.triu((score[None, :] - score[:, None]) >= 2 * TIE_TOL, 1))
    assert len(bad) == 0, [(got[i], got[j]) for i, j in bad[:5]]


@pytest.mark.parametrize("model", RANKED + ("neuralcf", "nerualcf"))
def test_exports_rank_in_jax_order(servers, model):
    jserver, tserver = servers
    cands, _ = jserver.rec_for_you._candidate_set()
    cand_ids = [c.movie_id for c in cands]
    name = "neuralcf" if model == "nerualcf" else model
    jscorer = jserver.rec_for_you.scorer if name == "neuralcf" else \
        jserver.rec_for_you.scorers[name]
    for user in USERS:
        ref = _ids(_get(jserver, "/getrecforyou", id=user, size=800, model=model))
        got = _ids(_get(tserver, "/getrecforyou", id=user, size=800, model=model))
        assert len(ref) == 800
        jscores = jscorer.score(user, cand_ids)
        tscores = tserver.rec_for_you.scorers[name].score(user, cand_ids)
        # 2.5e-5: the export logits' 1e-4 at most, times the slope 1/4.
        assert np.all(np.abs(tscores - jscores) <= 2.5e-5)
        _assert_same_order(got, ref, dict(zip(cand_ids, jscores.tolist())))


def test_id_only_wave_equals_single_scores(servers):
    _, tserver = servers
    scorer = TScorer(tserver.rec_for_you.scorers["neuralcf"].model, device="cpu")
    cand_ids = [c.movie_id for c in tserver.rec_for_you._candidate_set()[0]][:50]
    scorer.prepare_wave(cand_ids, 3)
    wave = scorer.score_wave([USERS[0], USERS[1], USERS[0]])
    np.testing.assert_allclose(wave[0], scorer.score(USERS[0], cand_ids), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(wave[1], scorer.score_many([USERS[1]], cand_ids)[0],
                               rtol=1e-6, atol=1e-7)
    assert set(scorer._wave["resident"]) == {"movieId"}


def test_ab_router_sends_the_nerualcf_bucket_to_neuralcf(servers):
    from sparrowrecsys_torch.serving.ab import get_config_by_user_id

    jserver, tserver = servers
    users = [u for u in sorted(tserver.dm.users)
             if get_config_by_user_id(str(u)) == "nerualcf"][:2]
    for s in servers:
        s.ab_test = True
    try:
        routed = [_get(tserver, "/getrecforyou", id=u, size=40, model="din") for u in users]
        ref = [_get(jserver, "/getrecforyou", id=u, size=40, model="din") for u in users]
    finally:
        for s in servers:
            s.ab_test = False
    for u, got, want in zip(users, routed, ref):
        assert got == _get(tserver, "/getrecforyou", id=u, size=40, model="neuralcf")
        assert got != _get(tserver, "/getrecforyou", id=u, size=40, model="x")
        assert _ids(got) == _ids(want)


def test_server_command_line_wires_model_dir_ab_test_and_dien():
    server = server_from_args([
        "--cpu", "--data-root", DATA, "--ab-test", "--model-dir", f"{DATA}/modeldata/neuralcf",
        "--rank-model", "dien", "--rank-model-dir", f"{DATA}/modeldata/dien"])
    scorers = server.rec_for_you.scorers
    assert server.ab_test and set(scorers) == {"neuralcf", "dien"}
    assert scorers["neuralcf"].assembler is None and scorers["neuralcf"].version == 2
    assert scorers["dien"].extra_int_cols == NEGATIVE_COLS
    assert set(server.watcher.scorers) == {"neuralcf", "dien"}    # both hot-reload
    server.ab_test = False
    for model in ("neuralcf", "nerualcf", "dien"):
        assert len(_ids(_get(server, "/getrecforyou", id=USERS[0], size=16, model=model))) == 16
    with pytest.raises(ValueError, match="two NeuralCF"):
        TServer(server.dm, scorers={"neuralcf": scorers["neuralcf"]},
                scorer=scorers["neuralcf"], device="cpu")


"""The port's models against the JAX zoo: same weights, same features, same
logits, both at small widths and for the shipped exports."""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparrowrecsys_torch.models import build_model as torch_build
from sparrowrecsys_torch.training.checkpoint import load_latest, params_from_flax
from sparrowrecsys_tpu.data.dataset import encode_samples, load_samples_csv
from sparrowrecsys_tpu.models import build_model as jax_build

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: float32 through a few small layers in another summation order.
TOL = dict(rtol=1e-5, atol=1e-5)


def assert_logits_close(got, ref):
    """1e-5 relative to the largest logit. The exports see raw numerics
    (releaseYear near 2000, counts in the thousands), so DIN's first layer
    sums terms up to ~600 in magnitude; two float32 summation orders then
    differ by up to ~1e-4 in a logit (measured 2.9e-5 on testSamples)."""
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(ref).max()))

SMALL = {
    "deepfm": dict(dim=4, deep_hidden=8, movie_buckets=50, user_buckets=60),
    "deepfm_v2": dict(dim=4, field_dim=8, deep_hidden=8, movie_buckets=50, user_buckets=60),
    "din": dict(dim=4, attention_hidden=8, hidden=8, movie_buckets=50, user_buckets=60),
}


def _features(n, rng, movie_buckets=50, user_buckets=60):
    """Random encoded features, with OOV genres (-1), history pads (0) and
    ids outside the tables."""
    f = {
        "movieId": rng.integers(0, movie_buckets + 3, n),
        "userId": rng.integers(-1, user_buckets + 3, n),
    }
    for k in range(1, 6):
        f[f"userRatedMovie{k}"] = rng.integers(0, movie_buckets, n) * (rng.random(n) < 0.7)
    for c in ("movieGenre1", "movieGenre2", "movieGenre3", "userGenre1", "userGenre2",
              "userGenre3", "userGenre4", "userGenre5"):
        f[c] = rng.integers(-1, 19, n)
    f = {k: v.astype(np.int32) for k, v in f.items()}
    for c in ("releaseYear", "movieRatingCount", "movieAvgRating", "movieRatingStddev",
              "userRatingCount", "userAvgRating", "userRatingStddev",
              "userAvgReleaseYear", "userReleaseYearStddev"):
        f[c] = rng.normal(size=n).astype(np.float32)
    return f


def _perturb(tree, rng):
    """Non-zero biases, PReLU slopes and id biases, so every term counts."""
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(scale=0.1, size=a.shape)).astype(np.float32),
        tree,
    )


def _logits_both(name, kwargs, tree, feats):
    jmodel = jax_build(name, **kwargs)
    ref = np.asarray(jmodel.apply({"params": tree}, {k: jnp.asarray(v) for k, v in feats.items()}))
    tmodel = torch_build(name, **kwargs)
    tmodel.load_state_dict(params_from_flax(tree, tmodel))
    with torch.no_grad():
        got = tmodel({k: torch.from_numpy(v) for k, v in feats.items()}).numpy()
    return got, ref


@pytest.mark.parametrize("dtypes", [
    {},
    # bf16 id tables before the gather; bf16 towers, rounded after the
    # product and again after the bias as flax rounds them. Each moves the
    # logits by 1e-4 to 6e-3 from float32, so holding them to TOL shows
    # the port rounds at the same points.
    {"lookup_dtype": "bfloat16"},
    {"compute_dtype": "bfloat16"},
], ids=["float32", "bf16_lookup", "bf16_towers"])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_small_models_match_jax_on_jax_initialised_weights(name, dtypes):
    rng = np.random.default_rng(0)
    kwargs = {**SMALL[name], **dtypes}
    feats = _features(64, rng)
    init = jax_build(name, **kwargs).init(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in feats.items()})["params"]
    got, ref = _logits_both(name, kwargs, _perturb(init, rng), feats)
    assert got.shape == (64,)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("name", ["deepfm", "deepfm_v2", "din"])
def test_shipped_exports_match_jax_on_test_samples(name):
    feats = encode_samples(load_samples_csv(os.path.join(REPO, "data/testSamples.csv"))).features
    feats = {k: v[:256] for k, v in feats.items()}
    tree, _, _ = load_latest(os.path.join(REPO, "data/modeldata", name))
    got, ref = _logits_both(name, {}, tree, feats)
    assert_logits_close(got, ref)


def test_reader_tree_and_flax_tree_give_the_same_model():
    """The tree the JAX model runs on above is the port's own decode; check
    it against flax's on one export."""
    path = os.path.join(REPO, "data/modeldata/din/001/params.msgpack")
    with open(path, "rb") as f:
        flax_tree = flax.serialization.msgpack_restore(f.read())
    tree, _, _ = load_latest(os.path.join(REPO, "data/modeldata/din"))
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: np.array_equal(np.asarray(a), np.asarray(b)), flax_tree, tree))

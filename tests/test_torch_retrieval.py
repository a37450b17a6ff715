"""The port's retrieval trainer (`sparrowrecsys_torch/training/retrieval.py`)
against the JAX package's on the CPU: both start from JAX's initial
params (`model.init(PRNGKey(seed))`, through `params_from_flax`) and take
JAX's per-epoch orders (`permutation(split(key)[1], n)[:steps * batch]`),
two epochs of a small two-tower, with logQ on and off, `l2_normalize`
with a temperature, and AdamW's decoupled weight decay.

Tolerance: with `l2_normalize`, every parameter within 1e-4 of its
largest magnitude (float32 in another summation order; optax's Adam and
the port's agree to the last bit on equal gradients), and the item and
user encodings within 1e-4 of theirs. Without it (the recall tool's
towers) 2e-2 of scale for the parameters and 1e-3 for the user x item
scores: under an in-batch softmax the item tower's last bias has a
gradient of exactly zero wherever its unit is active for every in-batch
item (each softmax row sums to one), and Adam (eps 1e-8) turns the
float32 remainder, whose sign differs between the packages, into steps
that the two runs do not share."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparrowrecsys_torch.data.dataset import EncodedDataset
from sparrowrecsys_torch.models import build_model as torch_build
from sparrowrecsys_torch.training.checkpoint import params_from_flax
from sparrowrecsys_torch.training.retrieval import RetrievalConfig, RetrievalTrainer
from sparrowrecsys_tpu.models import build_model as jax_build
from sparrowrecsys_tpu.training.retrieval import RetrievalConfig as JConfig
from sparrowrecsys_tpu.training.retrieval import RetrievalTrainer as JTrainer

TOL = 1e-4
#: 16-wide towers: at a 6-wide ReLU output a vector with one active unit
#: has an l2-normalized gradient of exactly zero, whose float32 remainder
#: (its sign differing between the packages) Adam turns into a full +-lr
#: step, and the two runs part far beyond rounding within two epochs.
SMALL = dict(dim=4, hidden=(16, 16), movie_buckets=50, user_buckets=60)
L2 = dict(l2_normalize=True, temperature=0.2)
#: case -> (RetrievalConfig fields, parameter tolerance, score tolerance)
CASES = {
    "l2_logq": (L2, TOL, TOL),
    "l2_no_logq": (dict(L2, logq=False), TOL, TOL),
    "l2_weight_decay": (dict(L2, weight_decay=0.01), TOL, TOL),
    "l2_temperature_1": (dict(l2_normalize=True), TOL, TOL),
    "unnormalized_logq": (dict(), 2e-2, 1e-3),
}


def _pairs(n=300, seed=0):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, 60, n).astype(np.int32)
    # popular items and a user-item affinity, so logQ and the towers matter
    movies = ((users * 7 + rng.integers(0, 5, n)) % 50).astype(np.int32)
    popular = rng.random(n) < 0.3
    movies[popular] = rng.integers(0, 5, int(popular.sum()))
    return users, movies


def jax_orders(cfg, n):
    bs = min(cfg.batch_size, n)
    steps = max(n // bs, 1)
    key = jax.random.PRNGKey(cfg.seed)
    out = []
    for _ in range(cfg.epochs):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.permutation(sub, n)[: steps * bs]))
    return out


def _fit_both(case):
    cfg = RetrievalConfig(batch_size=64, epochs=2, learning_rate=1e-2, seed=3, **CASES[case][0])
    users, movies = _pairs()
    jmodel = jax_build("neuralcf_two_tower", **SMALL)
    jtrainer = JTrainer(jmodel, JConfig(**dataclasses.asdict(cfg)))
    jparams0 = jmodel.init(jax.random.PRNGKey(cfg.seed),
                           {"movieId": jnp.zeros(2, jnp.int32), "userId": jnp.zeros(2, jnp.int32)})
    jparams = jtrainer.fit_pairs(users, movies)
    tmodel = torch_build("neuralcf_two_tower", **SMALL)
    trainer = RetrievalTrainer(tmodel, cfg, device="cpu")
    init = params_from_flax(jax.device_get(jparams0["params"]), tmodel)
    losses = []
    tparams = trainer.fit_pairs(users, movies, params=init,
                                orders=jax_orders(cfg, len(users)), losses=losses)
    return jtrainer, jparams, trainer, tparams, init, losses


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_epochs_land_on_jax_params(case):
    _, tol, score_tol = CASES[case]
    jtrainer, jparams, trainer, tparams, init, losses = _fit_both(case)
    want = params_from_flax(jax.device_get(jparams), trainer.model)
    moved = 0.0
    for name, w in want.items():
        w = w.numpy()
        scale = max(np.abs(w).max(), 1e-6)
        np.testing.assert_allclose(tparams[name].numpy(), w, rtol=0, atol=tol * scale,
                                   err_msg=name)
        moved = max(moved, float(np.abs(w - init[name].numpy()).max()))
    assert moved > 1e-3  # it trained
    assert len(losses) == 2 and np.isfinite(losses).all()
    jm = np.asarray(jtrainer.item_matrix(jparams, 50))
    tm = trainer.item_matrix(tparams, 50).numpy()
    ju = np.asarray(jtrainer.user_vectors(jparams, np.arange(60)))
    tu = trainer.user_vectors(tparams, np.arange(60)).numpy()
    if tol == TOL:
        np.testing.assert_allclose(tm, jm, rtol=0, atol=TOL * np.abs(jm).max())
        np.testing.assert_allclose(tu, ju, rtol=0, atol=TOL * np.abs(ju).max())
        np.testing.assert_allclose(np.linalg.norm(tm, axis=1), 1.0, atol=1e-5)
    scores = ju @ jm.T
    np.testing.assert_allclose(tu @ tm.T, scores, rtol=0, atol=score_tol * np.abs(scores).max())


def test_loss_falls_with_the_ports_own_orders():
    users, movies = _pairs(600, seed=1)
    cfg = RetrievalConfig(batch_size=64, epochs=8, learning_rate=1e-2, seed=0)
    trainer = RetrievalTrainer(torch_build("neuralcf_two_tower", **SMALL), cfg, device="cpu")
    losses = []
    trainer.fit_pairs(users, movies, losses=losses)
    assert losses[-1] < losses[0] - 0.1, losses


def test_fit_takes_the_positive_rows_and_refuses_none():
    users, movies = _pairs(200, seed=2)
    labels = (np.arange(200) % 2).astype(np.float32)
    ds = EncodedDataset({"userId": users, "movieId": movies}, labels)
    cfg = RetrievalConfig(batch_size=32, epochs=1, seed=0)
    a = RetrievalTrainer(torch_build("neuralcf_two_tower", **SMALL), cfg, device="cpu")
    b = RetrievalTrainer(torch_build("neuralcf_two_tower", **SMALL), cfg, device="cpu")
    pa = a.fit(ds)
    pb = b.fit_pairs(users[labels > 0.5], movies[labels > 0.5])
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    with pytest.raises(ValueError, match="positive"):
        a.fit(EncodedDataset({"userId": users, "movieId": movies}, np.zeros(200, np.float32)))

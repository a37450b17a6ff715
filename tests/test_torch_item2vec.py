"""The port's item2vec (`sparrowrecsys_torch/embedding/item2vec.py`) against
the JAX package's on the CPU.

- Sequences, pairs, vocabulary, counts and alias tables: bit for bit.
- One SGNS step against `_sgns_math`, and `train_sgns` fed JAX's initial
  table, epoch orders and negatives (its key schedule replayed with
  `jax.random`), on both of the JAX package's branches (one-hot products at
  V <= 2048, scatter-adds above): the tables agree within 1e-5 of the
  largest magnitude (float32 sums in another order).
- The port's own alias draws against counts^0.75: chi-square at a fixed
  seed below the 0.999 quantile.
- The port's own draws learn the planted two-cluster structure."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparrowrecsys_torch.data.movielens import Ratings as TRatings
from sparrowrecsys_torch.data.movielens import load_ratings
from sparrowrecsys_torch.embedding import item2vec as T
from sparrowrecsys_tpu.embedding import item2vec as J
from sparrowrecsys_tpu.ops.embedding import ONEHOT_GRAD_MAX_VOCAB
from tests.test_embedding import clustered_ratings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _port(r) -> TRatings:
    return TRatings(r.user_ids, r.movie_ids, r.ratings, r.timestamps)


def _pair_sequences(n_items: int, seed: int = 0):
    """Sequences of two distinct items covering 1..n_items once: a
    vocabulary of n_items with n_items pairs."""
    perm = np.random.default_rng(seed).permutation(n_items) + 1
    return [perm[i:i + 2].astype(np.int64) for i in range(0, n_items, 2)]


def jax_schedule(centers, counts, vocab_size, cfg):
    """JAX's initial table, per-epoch orders and per-step negatives, from
    `train_sgns`'s key schedule (item2vec.py:276-303, :241)."""
    packed = J.pack_alias(*J.build_alias_table(counts ** 0.75))
    key = jax.random.PRNGKey(cfg.seed)
    k1, key = jax.random.split(key)
    init = jax.random.uniform(k1, (vocab_size, cfg.dim), jnp.float32,
                              -0.5 / cfg.dim, 0.5 / cfg.dim)
    n = len(centers)
    bs = min(cfg.batch_size, max(n, 1))
    steps = max(n // bs, 1)
    chunk = min(steps, J.MAX_STEPS_PER_DISPATCH)
    orders, negatives = [], []
    for _ in range(cfg.epochs):
        key, kperm = jax.random.split(key)
        orders.append(np.asarray(jax.random.permutation(kperm, n)[: steps * bs]))
        epoch = []
        for lo in range(0, steps, chunk):
            key, sub = jax.random.split(key)
            for sk in jax.random.split(sub, min(lo + chunk, steps) - lo):
                epoch.append(np.asarray(J._alias_draw(packed, sk, (bs, cfg.negatives))))
        negatives.append(np.stack(epoch))
    return np.asarray(init), orders, negatives


def test_sequences_pairs_and_counts_bit_equal_on_the_bundled_ratings():
    ratings = load_ratings(os.path.join(REPO, "data", "ratings.csv"))
    seqs_t = T.build_item_sequences(ratings)
    seqs_j = J.build_item_sequences(ratings)
    assert len(seqs_t) == len(seqs_j) == 2672
    for a, b in zip(seqs_t, seqs_j):
        np.testing.assert_array_equal(a, b)
    for got, want in zip(T.skipgram_pairs(seqs_t, 5), J.skipgram_pairs(seqs_j, 5)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    c, _, vocab, _ = T.skipgram_pairs(seqs_t, 5)
    assert (len(vocab), len(c)) == (625, 11406)


def test_alias_tables_bit_equal_and_packed():
    rng = np.random.default_rng(0)
    p = (rng.random(301) + 0.01) ** 0.75
    for got, want in zip(T.build_alias_table(p), J.build_alias_table(p)):
        np.testing.assert_array_equal(got, want)
    prob, alias = T.build_alias_table(p)
    np.testing.assert_array_equal(T.pack_alias(prob, alias, device="cpu").numpy(),
                                  np.asarray(J.pack_alias(prob, alias)))


def test_alias_draw_distribution():
    rng = np.random.default_rng(0)
    counts = rng.integers(1, 50, 37).astype(np.float64)
    p = counts ** 0.75 / (counts ** 0.75).sum()
    packed = T.pack_alias(*T.build_alias_table(counts ** 0.75), device="cpu")
    n = 200_000
    draws = T.alias_draw(packed, (n,), torch.Generator().manual_seed(0)).numpy()
    obs = np.bincount(draws, minlength=37)
    chi2 = float(((obs - n * p) ** 2 / (n * p)).sum())
    assert chi2 < 69.3, chi2  # chi-square(36) 0.999 quantile


@pytest.mark.parametrize("vocab", [40, ONEHOT_GRAD_MAX_VOCAB + 100])
def test_one_step_matches_sgns_math(vocab):
    rng = np.random.default_rng(vocab)
    ein = rng.uniform(-0.3, 0.3, (vocab, 6)).astype(np.float32)
    eout = rng.uniform(-0.3, 0.3, (vocab, 6)).astype(np.float32)
    c = rng.integers(0, vocab, 64)
    x = rng.integers(0, vocab, 64)
    neg = rng.integers(0, vocab, (64, 5))
    ji, jo, jl = J._sgns_math(jnp.asarray(ein), jnp.asarray(eout), jnp.asarray(c, jnp.int32),
                              jnp.asarray(x, jnp.int32), jnp.asarray(neg, jnp.int32),
                              jnp.float32(0.05))
    ti, to = torch.from_numpy(ein.copy()), torch.from_numpy(eout.copy())
    tl = T.sgns_step(ti, to, torch.from_numpy(c), torch.from_numpy(x), torch.from_numpy(neg), 0.05)
    for got, want in ((ti, ji), (to, jo)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL * np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)


def _replay_case(branch):
    if branch == "onehot":
        seqs = T.build_item_sequences(_port(clustered_ratings()))
        cfg = T.Item2VecConfig(epochs=3, batch_size=256, seed=1)
    else:
        seqs = _pair_sequences(ONEHOT_GRAD_MAX_VOCAB + 152)
        cfg = T.Item2VecConfig(epochs=2, batch_size=512, learning_rate=0.05, seed=3)
    return seqs, cfg


@pytest.mark.parametrize("branch", ["onehot", "scatter"])
def test_train_sgns_on_jax_schedule_lands_on_jax_table(branch):
    seqs, cfg = _replay_case(branch)
    c, x, vocab, counts = T.skipgram_pairs(seqs, cfg.window)
    assert (len(vocab) <= ONEHOT_GRAD_MAX_VOCAB) == (branch == "onehot")
    want = J.train_sgns(c, x, len(vocab), counts, J.Item2VecConfig(**dataclasses.asdict(cfg)))
    init, orders, negatives = jax_schedule(c, counts, len(vocab), cfg)
    got = T.train_sgns(c, x, len(vocab), counts, cfg, device="cpu", init=init,
                       orders=orders, negatives=negatives)
    scale = np.abs(want).max()
    assert np.abs(got - init).max() > 100 * TOL * scale  # it trained
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


def test_train_sgns_checks_injected_shapes():
    seqs, cfg = _replay_case("onehot")
    c, x, vocab, counts = T.skipgram_pairs(seqs, cfg.window)
    with pytest.raises(ValueError, match="orders"):
        T.train_sgns(c, x, len(vocab), counts, cfg, device="cpu", orders=[np.arange(5)] * 3)
    with pytest.raises(ValueError, match="init"):
        T.train_sgns(c, x, len(vocab), counts, cfg, device="cpu", init=np.zeros((3, 10)))


def test_lr_schedule_is_jax_float32():
    cfg = T.Item2VecConfig()
    for t, total in ((0, 10), (3, 10), (9, 10), (10, 10), (168, 1690)):
        lr = T.sgns_lr(cfg, t, total)
        want = jnp.float32(cfg.learning_rate) * jnp.maximum(1.0 - jnp.float32(t) / total, 1e-4)
        assert lr == float(want)


def test_port_learns_the_cluster_structure_and_synonyms_match_jax():
    # tests/test_embedding.py's batch 1024 at lr 0.05 diverges to NaN in
    # both packages (20 items, about 50 updates to each row a step).
    cfg = T.Item2VecConfig(epochs=10, batch_size=256, seed=1)
    vocab, emb = T.train_item2vec(_port(clustered_ratings()), cfg, device="cpu")
    assert emb.shape == (20, 10) and np.isfinite(emb).all()
    ok = 0
    for v in vocab:
        syn = T.find_synonyms(vocab, emb, int(v), 5, device="cpu")
        assert syn == [(m, pytest.approx(s, abs=1e-6))
                       for m, s in J.find_synonyms(vocab, emb, int(v), 5)]
        ok += sum(1 for mid, _ in syn if (mid - 1) // 10 == (int(v) - 1) // 10)
    assert ok >= 95, ok
    assert T.find_synonyms(vocab, emb, 999, 5, device="cpu") == []

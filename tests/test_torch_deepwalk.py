"""The port's DeepWalk (`sparrowrecsys_torch/embedding/deepwalk.py`) against
the JAX package's on the CPU.

- Adjacent pairs, the dense transition matrix and the CSR graph: bit for bit.
- The CSR walker fed JAX's starts and uniforms (`_walk_csr`'s key schedule
  replayed) gives JAX's walks and valid masks element for element.
- The dense walker and the CSR walker, fed the same starts and uniforms,
  give the same walks, apart from steps whose uniform lies within 1e-6 of
  a row's cumulative boundary (counted, and excluded).
- The port's own draws: first-step frequencies of 20,000 walks against
  `transition_matrix` (chi-square at a fixed seed below the 0.999
  quantile), every step on an edge, dead ends truncating the walk."""

import os

import jax
import numpy as np
import pytest
import torch

from sparrowrecsys_torch.data.movielens import load_ratings
from sparrowrecsys_torch.embedding import deepwalk as T
from sparrowrecsys_torch.embedding.item2vec import Item2VecConfig, build_item_sequences
from sparrowrecsys_tpu.embedding import deepwalk as J

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDARY = 1e-6


@pytest.fixture(scope="module")
def bundled_sequences():
    return build_item_sequences(load_ratings(os.path.join(REPO, "data", "ratings.csv")))


def _csr_tensors(csr):
    return (torch.from_numpy(csr.rowptr), torch.from_numpy(csr.dst), torch.from_numpy(csr.cum))


def test_graph_builders_bit_equal(bundled_sequences):
    for got, want in zip(T.adjacent_pairs(bundled_sequences), J.adjacent_pairs(bundled_sequences)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for got, want in zip(T.transition_matrix(bundled_sequences),
                         J.transition_matrix(bundled_sequences)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    got, want = T.transition_csr(bundled_sequences), J.transition_csr(bundled_sequences)
    for name in ("vocab_ids", "rowptr", "dst", "cum", "item_dist"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)
    assert len(got.vocab_ids) == 625


def _jax_csr_walks(csr, n_walks, length, seed):
    """JAX's walks, and the starts and uniforms it drew (_walk_csr, :140-159)."""
    iters = T.bisect_iters(csr.rowptr)
    log_dist = jax.numpy.log(jax.numpy.asarray(csr.item_dist) + 1e-30)
    key = jax.random.PRNGKey(seed)
    walks, valid = J._walk_csr(key, jax.numpy.asarray(csr.rowptr), jax.numpy.asarray(csr.dst),
                               jax.numpy.asarray(csr.cum), log_dist, n_walks, length, iters)
    keys = jax.random.split(jax.random.split(key)[1], length - 1)
    uniforms = np.stack([np.asarray(jax.random.uniform(k, (n_walks,))) for k in keys])
    return np.asarray(walks), np.asarray(valid), iters, uniforms


def test_csr_walks_equal_jax_under_its_draws(bundled_sequences):
    csr = T.transition_csr(bundled_sequences)
    walks, valid, iters, uniforms = _jax_csr_walks(csr, 3000, 10, seed=5)
    walks = walks.copy()
    assert (~valid).any() and valid[:, 1:].any()  # dead ends and live steps both occur
    got_w, got_v = T.walk_csr(*_csr_tensors(csr), torch.from_numpy(walks[:, 0]),
                              torch.from_numpy(uniforms), iters)
    np.testing.assert_array_equal(got_w.numpy(), walks)
    np.testing.assert_array_equal(got_v.numpy(), valid)


def test_csr_walker_past_a_rows_last_cum_lands_on_its_last_edge():
    """A uniform above a row's last cum (1.0 here) lands on the row's last
    edge, as the bisection's clamp to hi - 1 gives it."""
    seqs = [np.array([1, 2]), np.array([1, 3]), np.array([1, 4]), np.array([2, 3])]
    csr = T.transition_csr(seqs)
    u = torch.tensor([[1.5, 1.5]])
    got_w, got_v = T.walk_csr(*_csr_tensors(csr), torch.tensor([0, 1]), u,
                              T.bisect_iters(csr.rowptr))
    assert got_w.tolist() == [[0, 3], [1, 2]]
    assert got_v.tolist() == [[True, True], [True, True]]


def test_dense_and_csr_walkers_agree(bundled_sequences):
    vocab, trans, dist = T.transition_matrix(bundled_sequences)
    csr = T.transition_csr(bundled_sequences)
    gen = torch.Generator().manual_seed(11)
    start, uniforms = T.walk_draws(dist, 4000, 10, gen)
    dense_w, dense_v = T.walk_dense(torch.from_numpy(T.dense_cdf(trans)),
                                    torch.from_numpy(dist == 0), start, uniforms)
    csr_w, csr_v = T.walk_csr(*_csr_tensors(csr), start, uniforms, T.bisect_iters(csr.rowptr))
    # Steps whose uniform is within BOUNDARY of a cumulative boundary of the
    # row the walker stands on may differ (two float32 CDFs).
    cur = csr_w[:, :-1].numpy()
    u = uniforms.T.numpy()
    near = np.zeros(u.shape, bool)
    for w in range(u.shape[0]):
        for t in range(u.shape[1]):
            lo, hi = csr.rowptr[cur[w, t]], csr.rowptr[cur[w, t] + 1]
            near[w, t] = (np.abs(csr.cum[lo:hi] - u[w, t]) < BOUNDARY).any()
    first_near = np.where(near.any(1), near.argmax(1), u.shape[1])
    ok = np.arange(u.shape[1] + 1)[None, :] <= first_near[:, None]
    print(f"{near.sum()} of {near.size} steps within {BOUNDARY} of a boundary")
    assert near.sum() <= 0.001 * near.size
    np.testing.assert_array_equal(dense_w.numpy()[ok], csr_w.numpy()[ok])
    np.testing.assert_array_equal(dense_v.numpy()[ok], csr_v.numpy()[ok])


def test_first_step_frequencies_match_the_transition_matrix():
    rng = np.random.default_rng(3)
    seqs = [rng.choice(12, size=int(rng.integers(2, 7)), replace=False) + 1 for _ in range(300)]
    vocab, trans, dist = T.transition_matrix(seqs)
    n = 20000
    start, uniforms = T.walk_draws(dist, n, 2, torch.Generator().manual_seed(0))
    walks, valid = T.walk_dense(torch.from_numpy(T.dense_cdf(trans)),
                                torch.from_numpy(dist == 0), start, uniforms)
    w = walks.numpy()
    live = valid.numpy()[:, 1]
    obs = np.zeros_like(trans, dtype=np.float64)
    np.add.at(obs, (w[live, 0], w[live, 1]), 1.0)
    exp = np.bincount(w[live, 0], minlength=len(vocab))[:, None] * trans.astype(np.float64)
    edge = exp > 0
    assert obs[~edge].sum() == 0  # every step follows an edge
    chi2 = float(((obs[edge] - exp[edge]) ** 2 / exp[edge]).sum())
    dof = int(edge.sum()) - int((exp.sum(1) > 0).sum())
    assert chi2 < dof + 3.1 * np.sqrt(2 * dof) + 10, (chi2, dof)  # about the 0.999 quantile
    # the starts follow item_dist
    s_obs = np.bincount(w[:, 0], minlength=len(vocab))
    s_exp = n * dist.astype(np.float64)
    keep = s_exp > 0
    assert s_obs[~keep].sum() == 0
    s_chi2 = float(((s_obs[keep] - s_exp[keep]) ** 2 / s_exp[keep]).sum())
    s_dof = int(keep.sum()) - 1
    assert s_chi2 < s_dof + 3.1 * np.sqrt(2 * s_dof) + 10, (s_chi2, s_dof)


@pytest.mark.parametrize("walker", ["dense", "csr"])
def test_dead_ends_truncate_and_every_step_follows_an_edge(walker, monkeypatch):
    # 1 -> 2 -> 3 -> 4, 4 has no out-edges; 5 <-> 6 cycle
    seqs = [np.array([1, 2, 3, 4]), np.array([5, 6, 5, 6])]
    if walker == "csr":
        monkeypatch.setattr(T, "DENSE_WALK_MAX_VOCAB", 2)
    cfg = T.DeepWalkConfig(sample_count=500, sample_length=6, seed=1)
    vocab, walks = T.random_walks(seqs, cfg, device="cpu")
    edges = {(1, 2), (2, 3), (3, 4), (5, 6), (6, 5)}
    assert vocab.tolist() == [1, 2, 3, 4, 5, 6]
    for w in walks:
        assert all((int(a), int(b)) in edges for a, b in zip(w[:-1], w[1:])), w
        assert w[0] != 4  # item 4 has no out-edges, so no start there
        if 4 in w:
            assert w[-1] == 4 and len(w) < 6
        else:
            assert len(w) == 6


def test_train_deepwalk_vocabulary_is_the_walks(monkeypatch):
    seqs_ratings = load_ratings(os.path.join(REPO, "data", "ratings.csv"))
    cfg = T.DeepWalkConfig(sample_count=300, sample_length=4, seed=2,
                           item2vec=Item2VecConfig(epochs=1, batch_size=512))
    vocab, emb = T.train_deepwalk(seqs_ratings, cfg, device="cpu")
    _, walks = T.random_walks(build_item_sequences(seqs_ratings), cfg, device="cpu")
    want = np.unique(np.concatenate([w for w in walks if len(w) >= 1]))
    np.testing.assert_array_equal(vocab, want)
    assert emb.shape == (len(want), 10) and np.isfinite(emb).all()
    assert len(vocab) < 625  # items no walk visits are absent

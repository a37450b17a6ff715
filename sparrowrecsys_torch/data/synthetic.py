"""Synthetic datasets with a planted signal: copies of
`sparrowrecsys_tpu/data/synthetic.py::synthetic_ratings` (:22-60, rating
events at MovieLens-20M's user and movie counts for the feature job),
`synthetic_ctr_dataset` (:63) and `synthetic_sequence_ctr_dataset` (:95)
with the helpers they need.

numpy only: the same arguments give the same rows in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from sparrowrecsys_torch.data.dataset import EncodedDataset
from sparrowrecsys_torch.data.movielens import Ratings

_GENRE_COLS = ("userGenre1", "userGenre2", "userGenre3", "userGenre4",
               "userGenre5", "movieGenre1", "movieGenre2", "movieGenre3")
_NUMERIC_COLS = ("releaseYear", "movieRatingCount", "movieAvgRating",
                 "movieRatingStddev", "userRatingCount", "userAvgRating",
                 "userRatingStddev")


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    n_users: int = 138_000     # MovieLens-20M scale
    n_movies: int = 27_000
    n_events: int = 1_000_000
    latent_dim: int = 8
    #: per-user / per-movie rating-bias scales (MovieLens-like marginals:
    #: without them every engineered user/movie statistic is noise)
    user_bias_scale: float = 0.5
    movie_bias_scale: float = 0.4
    #: mean rating; 3.0 puts about half the events over the 3.5 label line
    base_rating: float = 3.0
    seed: int = 7


def synthetic_ratings(spec: SyntheticSpec = SyntheticSpec()) -> Ratings:
    """Events drawn from a planted biased low-rank preference model:
    rating ~ clipped affine of (user bias + movie bias + latent dot)."""
    rng = np.random.default_rng(spec.seed)
    uf = rng.normal(size=(spec.n_users, spec.latent_dim)).astype(np.float32)
    vf = rng.normal(size=(spec.n_movies, spec.latent_dim)).astype(np.float32)
    ub = (spec.user_bias_scale * rng.normal(size=spec.n_users)).astype(np.float32)
    mb = (spec.movie_bias_scale * rng.normal(size=spec.n_movies)).astype(np.float32)
    u = rng.integers(1, spec.n_users + 1, spec.n_events).astype(np.int32)
    m = rng.integers(1, spec.n_movies + 1, spec.n_events).astype(np.int32)
    affinity = np.einsum("nd,nd->n", uf[u - 1], vf[m - 1]) / np.sqrt(spec.latent_dim)
    score = spec.base_rating + ub[u - 1] + mb[m - 1] + affinity
    r = np.clip(np.round((score + 0.3 * rng.normal(size=spec.n_events)) * 2) / 2, 0.5, 5.0)
    t = rng.integers(1_000_000_000, 1_600_000_000, spec.n_events).astype(np.int64)
    return Ratings(u, m, r.astype(np.float32), t)


def synthetic_ctr_dataset(
    n: int,
    user_vocab: int = 30001,
    movie_vocab: int = 1001,
    seed: int = 0,
) -> EncodedDataset:
    """CTR samples in the 27-column feature layout with a planted signal
    on two N(0, 1) numerics and the movie id's parity."""
    rng = np.random.default_rng(seed)
    feats: Dict[str, np.ndarray] = {
        "movieId": rng.integers(1, movie_vocab, n).astype(np.int32),
        "userId": rng.integers(1, user_vocab, n).astype(np.int32),
    }
    for c in ("userRatedMovie1", "userRatedMovie2", "userRatedMovie3",
              "userRatedMovie4", "userRatedMovie5"):
        feats[c] = rng.integers(0, movie_vocab, n).astype(np.int32)
    for c in _GENRE_COLS:
        feats[c] = rng.integers(-1, 19, n).astype(np.int32)
    for c in _NUMERIC_COLS:
        feats[c] = rng.normal(size=n).astype(np.float32)
    logit = (
        1.5 * feats["userAvgRating"]
        - 0.8 * feats["movieRatingStddev"]
        + 0.3 * (feats["movieId"] % 2)
    )
    labels = (logit + 0.5 * rng.normal(size=n) > 0).astype(np.float32)
    return EncodedDataset(feats, labels)


def synthetic_sequence_ctr_dataset(
    n: int,
    movie_vocab: int = 1001,
    user_vocab: int = 30001,
    seed: int = 0,
    t: int = 5,
    recency: float = 0.6,
    gain: float = 3.0,
    compat_dim: int = 8,
    markov_tau: float = 1.5,
) -> EncodedDataset:
    """CTR samples whose only signal is sequential: the label depends on a
    planted low-rank compatibility between the candidate and the recent
    history, with recency-decayed weights,

        logit = gain * sum_t recency^t * <A[hist_t], B[cand]> / norm,

    and the history is a Markov walk under the same planted kernel. Every
    other column is independent noise, so DIN's target attention can find
    the signal and models without a history-candidate channel cannot."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(movie_vocab, compat_dim)).astype(np.float32)
    b = rng.normal(size=(movie_vocab, compat_dim)).astype(np.float32)
    if markov_tau > 0:
        hist = _markov_history(rng, a, b, n, t, markov_tau, compat_dim)
    else:
        hist = rng.integers(1, movie_vocab, (n, t)).astype(np.int32)
    cand = rng.integers(1, movie_vocab, n).astype(np.int32)
    w = (recency ** np.arange(t)).astype(np.float32)
    compat = np.einsum("ntd,nd->nt", a[hist], b[cand]) / np.sqrt(compat_dim)
    logit = gain * (compat @ w) / float(np.linalg.norm(w))
    labels = (rng.random(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)

    feats: Dict[str, np.ndarray] = {
        "movieId": cand,
        "userId": rng.integers(1, user_vocab, n).astype(np.int32),
    }
    for k in range(t):
        feats[f"userRatedMovie{k + 1}"] = hist[:, k]
    for c in _GENRE_COLS:
        feats[c] = rng.integers(-1, 19, n).astype(np.int32)
    for c in _NUMERIC_COLS:
        feats[c] = rng.normal(size=n).astype(np.float32)
    return EncodedDataset(feats, labels)


def _markov_history(rng, a, b, n, t, tau, compat_dim):
    """[n, t] walk, column t-1 oldest -> column 0 most recent (the
    userRatedMovie1..t layout is most-recent-first). Ids in [1, vocab).
    Per-row Walker alias tables make each draw O(1)."""
    vocab = a.shape[0]
    logits = tau * (a[1:] @ b[1:].T) / np.sqrt(compat_dim)
    logits -= logits.max(axis=1, keepdims=True)
    p = np.exp(logits, dtype=np.float64)
    p /= p.sum(axis=1, keepdims=True)
    v = vocab - 1
    prob = np.empty((v, v), np.float32)
    alias = np.empty((v, v), np.int32)
    for i in range(v):
        prob[i], alias[i] = _walker_alias_row(p[i])
    hist = np.empty((n, t), np.int32)
    hist[:, t - 1] = rng.integers(1, vocab, n)
    for step in range(t - 2, -1, -1):
        prev = hist[:, step + 1] - 1
        idx = rng.integers(0, v, n)
        keep = rng.random(n) < prob[prev, idx]
        hist[:, step] = 1 + np.where(keep, idx, alias[prev, idx])
    return hist


def _walker_alias_row(p: np.ndarray):
    """(prob, alias) Walker tables for one categorical row (O(V) build)."""
    v = len(p)
    scaled = p / p.sum() * v
    prob = np.ones(v)
    alias = np.arange(v)
    small = [i for i in range(v) if scaled[i] < 1.0]
    large = [i for i in range(v) if scaled[i] >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] -= 1.0 - scaled[s]
        (small if scaled[l] < 1.0 else large).append(l)
    return prob, alias

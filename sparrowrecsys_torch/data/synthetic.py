"""Synthetic CTR datasets with a planted signal: copies of
`sparrowrecsys_tpu/data/synthetic.py::synthetic_ctr_dataset` (:63) and
`synthetic_sequence_ctr_dataset` (:95) with the helpers they need.

numpy only: the same arguments give the same rows in both packages.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from sparrowrecsys_torch.data.dataset import EncodedDataset

_GENRE_COLS = ("userGenre1", "userGenre2", "userGenre3", "userGenre4",
               "userGenre5", "movieGenre1", "movieGenre2", "movieGenre3")
_NUMERIC_COLS = ("releaseYear", "movieRatingCount", "movieAvgRating",
                 "movieRatingStddev", "userRatingCount", "userAvgRating",
                 "userRatingStddev")


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

"""User embeddings, the mean of the watched movies' item vectors: a copy of
`sparrowrecsys_tpu/embedding/user_emb.py` (`generateUserEmb`,
Embedding.scala:75-126).

Every rating event counts (no rating filter); events whose movie has no
item vector are skipped (Embedding.scala:93). `mode="sum"` gives the
PySpark mirror's sum (Embedding.py:275-276). numpy on the host: a
segment sum over the ratings table.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from sparrowrecsys_torch.data.movielens import Ratings


def generate_user_emb(
    ratings: Ratings,
    item_vocab: np.ndarray,
    item_emb: np.ndarray,
    mode: str = "mean",
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (user_ids [U], embeddings [U, D] float32)."""
    if mode not in ("mean", "sum"):
        raise ValueError(f"mode must be 'mean' or 'sum', got {mode!r}")
    max_item = int(item_vocab.max()) if len(item_vocab) else 0
    lut = np.full(max_item + 1, -1, np.int64)
    lut[item_vocab.astype(np.int64)] = np.arange(len(item_vocab))
    mids = ratings.movie_ids.astype(np.int64)
    rows = np.where(mids <= max_item, lut[np.minimum(mids, max_item)], -1)
    keep = rows >= 0
    users = ratings.user_ids[keep].astype(np.int64)
    vecs = item_emb[rows[keep]]

    user_ids, inv = np.unique(users, return_inverse=True)
    d = item_emb.shape[1]
    acc = np.zeros((len(user_ids), d), np.float64)
    np.add.at(acc, inv, vecs)
    if mode == "mean":
        counts = np.bincount(inv, minlength=len(user_ids)).astype(np.float64)
        acc /= counts[:, None]
    return user_ids, acc.astype(np.float32)

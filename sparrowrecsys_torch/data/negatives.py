"""DIEN's negative-history columns: a copy of
`sparrowrecsys_tpu/data/negatives.py::add_dien_negatives` (:28).

For each of userRatedMovie2..T, a movie id drawn uniformly from
[0, vocab) and redrawn where it equals that column's id, from a numpy
`default_rng(seed)`: the same seed gives the same columns, bit for bit,
in both packages (the reference seeds 2020 for train and 2021 for test).
A negative may still equal the user's other history ids, as in the
reference, which excludes only the id in its own column.
"""

from __future__ import annotations

import numpy as np

from sparrowrecsys_torch.config import MOVIE_VOCAB_SIZE
from sparrowrecsys_torch.data.dataset import EncodedDataset


def add_dien_negatives(
    ds: EncodedDataset,
    seed: int,
    vocab: int = MOVIE_VOCAB_SIZE,
    recent_movies: int = 5,
) -> EncodedDataset:
    rng = np.random.default_rng(seed)
    n = len(ds)
    feats = dict(ds.features)
    for k in range(2, recent_movies + 1):
        pos = feats[f"userRatedMovie{k}"]
        neg = rng.integers(0, vocab, size=n)
        clash = neg == pos
        while clash.any():
            neg[clash] = rng.integers(0, vocab, size=int(clash.sum()))
            clash = neg == pos
        feats[f"negativeUserRatedMovie{k}"] = neg.astype(np.int32)
    return EncodedDataset(feats, ds.labels)

"""Encoded datasets: the port of `sparrowrecsys_tpu/data/dataset.py`.

A reference-format sample CSV is decoded and vocab-encoded once into
dense int32/float32 numpy columns; batching is array slicing. numpy only,
so the same file gives the same columns in both packages.

Missing values follow the reference: `na_value="0"` turns missing history
movieIds into id 0 (masked by `mask_zero` models), and genre strings
outside the 19-genre vocabulary become -1 (a zero embedding).
"""

from __future__ import annotations

import csv
import dataclasses
import math
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from sparrowrecsys_torch.config import GENRE_VOCAB
from sparrowrecsys_torch.data.schema import (
    EXTRA_NUMERIC_COLUMNS,
    GENRE_COLUMNS,
    HISTORY_COLUMNS,
    NUMERIC_COLUMNS,
    SAMPLE_COLUMNS,
    SampleTable,
)

_GENRE_TO_IDX = {g: i for i, g in enumerate(GENRE_VOCAB)}

INT_FEATURES = ["movieId", "userId"] + HISTORY_COLUMNS
GENRE_FEATURES = list(GENRE_COLUMNS)
FLOAT_FEATURES = list(NUMERIC_COLUMNS) + list(EXTRA_NUMERIC_COLUMNS)


def _parse_float(s: str) -> float:
    # na_value="0": missing or non-finite numerics become 0.
    if s == "" or s == "NULL" or s == "null":
        return 0.0
    try:
        v = float(s)
    except ValueError:
        return 0.0
    return v if math.isfinite(v) else 0.0


def load_samples(path: str) -> SampleTable:
    """Parse a reference-format 27-column sample CSV into a SampleTable
    (genre strings -> vocab indices with -1 OOV/missing; history '' -> 0).

    The copy of `load_samples_csv`; the JAX package's `load_samples` runs
    the same parse in its C++ loader, column-equal (tests/test_native.py).
    Truncated rows are skipped, as both loaders do."""
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = list(reader)
    col_pos = {c: header.index(c) for c in SAMPLE_COLUMNS if c in header}
    width = max(col_pos.values()) + 1
    rows = [r for r in rows if len(r) >= width]
    cols: Dict[str, np.ndarray] = {}

    def grab(c: str):
        p = col_pos[c]
        return [r[p] for r in rows]

    for c in ("movieId", "userId", "label", "releaseYear", "movieRatingCount",
              "userRatingCount", "userAvgReleaseYear", "timestamp"):
        dt = np.int64 if c == "timestamp" else np.int32
        cols[c] = np.array([int(_parse_float(v)) for v in grab(c)], dtype=dt)
    for c in ("rating", "movieAvgRating", "movieRatingStddev",
              "userAvgRating", "userRatingStddev", "userReleaseYearStddev"):
        cols[c] = np.array([_parse_float(v) for v in grab(c)], dtype=np.float32)
    for c in HISTORY_COLUMNS:
        cols[c] = np.array([int(_parse_float(v)) for v in grab(c)], dtype=np.int32)
    for c in GENRE_COLUMNS:
        cols[c] = np.array([_GENRE_TO_IDX.get(v, -1) for v in grab(c)], dtype=np.int32)
    return SampleTable(cols)


@dataclasses.dataclass
class EncodedDataset:
    """Dense feature arrays + labels.

    features: name -> array [N] (int32 for ids/genres, float32 numerics)
    labels:   float32 [N]
    """

    features: Dict[str, np.ndarray]
    labels: np.ndarray

    def __len__(self) -> int:
        return len(self.labels)

    def slice(self, idx: np.ndarray) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        return {k: v[idx] for k, v in self.features.items()}, self.labels[idx]

    def batches(
        self,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_remainder: bool = False,
        pad_final: bool = False,
    ) -> Iterator[Tuple[Dict[str, np.ndarray], np.ndarray, Optional[np.ndarray]]]:
        """Yield (features, labels, valid_mask). valid_mask is None except
        for a padded final batch (pad_final=True pads with row 0 to keep
        one batch shape)."""
        n = len(self)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        full = n // batch_size
        for b in range(full):
            idx = order[b * batch_size : (b + 1) * batch_size]
            f, l = self.slice(idx)
            yield f, l, None
        rem = n - full * batch_size
        if rem and not drop_remainder:
            idx = order[full * batch_size :]
            if pad_final:
                pad = np.concatenate([idx, np.zeros(batch_size - rem, dtype=idx.dtype)])
                f, l = self.slice(pad)
                mask = np.zeros(batch_size, dtype=np.float32)
                mask[:rem] = 1.0
                yield f, l, mask
            else:
                f, l = self.slice(idx)
                yield f, l, None


def standardize(
    train: EncodedDataset, *others: "EncodedDataset"
) -> Tuple["EncodedDataset", ...]:
    """Z-score the numeric columns with TRAIN statistics (opt-in; the
    reference feeds raw numerics such as releaseYear near 2000)."""
    stats = {}
    for c in FLOAT_FEATURES:
        v = train.features[c]
        mu, sd = float(v.mean()), float(v.std())
        stats[c] = (mu, sd if sd > 1e-6 else 1.0)

    def apply(ds: EncodedDataset) -> EncodedDataset:
        feats = dict(ds.features)
        for c, (mu, sd) in stats.items():
            feats[c] = ((ds.features[c] - mu) / sd).astype(np.float32)
        return EncodedDataset(feats, ds.labels)

    return tuple(apply(d) for d in (train, *others))


def encode_samples(table: SampleTable) -> EncodedDataset:
    """SampleTable -> EncodedDataset (drops rating/timestamp bookkeeping);
    history columns past userRatedMovie5 pass through."""
    feats: Dict[str, np.ndarray] = {}
    int_cols = list(INT_FEATURES) + sorted(
        (c for c in table.columns if c.startswith("userRatedMovie")
         and c not in INT_FEATURES),
        key=lambda c: int(c[len("userRatedMovie"):]),
    )
    for c in int_cols + GENRE_FEATURES:
        feats[c] = table[c].astype(np.int32)
    for c in FLOAT_FEATURES:
        feats[c] = table[c].astype(np.float32)
    labels = table["label"].astype(np.float32)
    return EncodedDataset(feats, labels)

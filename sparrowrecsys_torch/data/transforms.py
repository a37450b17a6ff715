"""Feature-encoding transforms, the `FeatureEngineering` demo toolkit: a
copy of `sparrowrecsys_tpu/data/transforms.py` (numpy).

The rebuild of `offline/spark/featureeng/FeatureEngineering.scala` as
vectorized numpy utilities instead of a DataFrame pipeline engine:

- `one_hot`: `OneHotEncoderEstimator` over movieId (scala:32-41);
- `multi_hot`: genre multi-hot via the explode + StringIndexer +
  sparse-vector UDF dance (scala:52-79) — here one scatter;
- `QuantileDiscretizer(numBuckets=100)` (scala:105-110): bucket by
  empirical quantiles, fit/transform split like Spark ML;
- `MinMaxScaler` (scala:113-118);
- `movie_rating_stats`: per-movie count/avg/variance (scala:95-102).

These mirror Spark ML's fit/transform contract with plain dataclasses so
the "feature demo" capability of the reference survives the rebuild.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


def one_hot(values: np.ndarray, num_classes: int) -> np.ndarray:
    """[N] int -> [N, num_classes] 0/1 float32. (Spark's OneHotEncoder drops
    the last category by default; we keep all — the demo prints, nothing
    consumes the width.)"""
    out = np.zeros((len(values), num_classes), np.float32)
    ok = (values >= 0) & (values < num_classes)
    out[np.arange(len(values))[ok], values[ok]] = 1.0
    return out


@dataclasses.dataclass
class StringIndexer:
    """Spark ML StringIndexer: labels ordered by descending frequency."""

    labels: List[str]

    def __post_init__(self) -> None:
        self._lut = {l: i for i, l in enumerate(self.labels)}

    @classmethod
    def fit(cls, values: Sequence[str]) -> "StringIndexer":
        uniq, counts = np.unique(np.asarray(values, dtype=object), return_counts=True)
        order = np.lexsort((uniq, -counts))  # freq desc, ties alphabetical
        return cls([str(u) for u in uniq[order]])

    def transform(self, values: Sequence[str]) -> np.ndarray:
        return np.array([self._lut.get(v, -1) for v in values], np.int64)


def multi_hot(genre_lists: Sequence[Sequence[str]]) -> Tuple[np.ndarray, StringIndexer]:
    """[[genre, ...], ...] -> ([N, V] 0/1, fitted indexer). One scatter
    replaces the reference's explode/collect_list round trip."""
    flat = [g for gs in genre_lists for g in gs]
    indexer = StringIndexer.fit(flat) if flat else StringIndexer([])
    v = len(indexer.labels)
    out = np.zeros((len(genre_lists), v), np.float32)
    # One flattened transform + row-id scatter: O(rows + items).
    if flat:
        row_ids = np.repeat(
            np.arange(len(genre_lists)), [len(gs) for gs in genre_lists]
        )
        idx = indexer.transform(flat)
        ok = idx >= 0
        out[row_ids[ok], idx[ok]] = 1.0
    return out, indexer


@dataclasses.dataclass
class QuantileDiscretizer:
    """Spark ML QuantileDiscretizer(numBuckets): splits at empirical
    quantiles; transform maps values into [0, numBuckets) buckets."""

    splits: np.ndarray  # interior boundaries, ascending

    @classmethod
    def fit(cls, values: np.ndarray, num_buckets: int = 100) -> "QuantileDiscretizer":
        qs = np.quantile(values, np.linspace(0, 1, num_buckets + 1)[1:-1])
        return cls(np.unique(qs))

    def transform(self, values: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.splits, values, side="right").astype(np.int64)


@dataclasses.dataclass
class MinMaxScaler:
    lo: np.ndarray
    hi: np.ndarray

    @classmethod
    def fit(cls, values: np.ndarray) -> "MinMaxScaler":
        v = np.asarray(values, np.float64)
        return cls(v.min(axis=0, keepdims=True), v.max(axis=0, keepdims=True))

    def transform(self, values: np.ndarray) -> np.ndarray:
        rng = np.where(self.hi - self.lo == 0, 1.0, self.hi - self.lo)
        # Spark maps constant columns to 0.5.
        mid = (self.hi - self.lo) == 0
        out = (np.asarray(values, np.float64) - self.lo) / rng
        out = np.where(mid, 0.5, out)
        return out.astype(np.float32)


def movie_rating_stats(
    movie_ids: np.ndarray, ratings: np.ndarray
) -> Dict[str, np.ndarray]:
    """Per-movie count / avg / sample variance (scala:95-102's groupBy agg)."""
    uniq, inv = np.unique(movie_ids, return_inverse=True)
    count = np.bincount(inv)
    total = np.bincount(inv, weights=ratings)
    total_sq = np.bincount(inv, weights=ratings.astype(np.float64) ** 2)
    avg = total / count
    with np.errstate(invalid="ignore"):
        var = (total_sq - total ** 2 / count) / np.maximum(count - 1, 1)
    var[count < 2] = np.nan  # Spark variance of a single row is NaN
    return {"movieId": uniq, "count": count, "avgRating": avg, "ratingVar": var}


def main() -> None:
    """`FeatureEngineering.main` parity — the printing demo
    (`offline/spark/featureeng/FeatureEngineering.scala:125-158`): one-hot
    of movieId, genre multi-hot, per-movie rating stats with a
    100-bucket QuantileDiscretizer + MinMaxScaler."""
    import argparse

    from sparrowrecsys_torch.config import DataConfig
    from sparrowrecsys_torch.data.movielens import load_movies, load_ratings

    ap = argparse.ArgumentParser()
    ap.add_argument("--data-root", default=None)
    args = ap.parse_args()
    data = DataConfig() if args.data_root is None else DataConfig(data_root=args.data_root)
    catalog = load_movies(data.path(data.movies_csv))
    ratings = load_ratings(data.path(data.ratings_csv))

    oh = one_hot(catalog.movie_ids[:10] % 1001, 1001)
    print(f"one-hot sample: shape={oh.shape}, nonzeros={int(oh.sum())}")

    mh, indexer = multi_hot(catalog.genres[:10])
    print(f"multi-hot sample: shape={mh.shape}, vocab={indexer.labels[:5]}...")

    stats = movie_rating_stats(ratings.movie_ids, ratings.ratings)
    qd = QuantileDiscretizer.fit(stats["count"].astype(np.float64), 100)
    buckets = qd.transform(stats["count"].astype(np.float64))
    sc = MinMaxScaler.fit(stats["avgRating"][:, None])
    scaled = sc.transform(stats["avgRating"][:, None])
    for i in range(min(5, len(stats["movieId"]))):
        print(
            f"movie {stats['movieId'][i]}: count={stats['count'][i]} "
            f"avg={stats['avgRating'][i]:.2f} var={stats['ratingVar'][i]:.2f} "
            f"countBucket={buckets[i]} scaledAvg={scaled[i,0]:.3f}"
        )


if __name__ == "__main__":
    main()

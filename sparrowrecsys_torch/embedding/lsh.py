"""Bucketed random-projection LSH: a copy of
`sparrowrecsys_tpu/embedding/lsh.py` (`embeddingLSH`,
Embedding.scala:274-296: `BucketedRandomProjectionLSH(bucketLength=0.1,
numHashTables=3)` and `approxNearestNeighbors(k=5)`).

h(x) = floor((x . w) / bucketLength) per table, with unit-norm gaussian
projections from `np.random.default_rng(seed)` (the same projections and
buckets as the JAX package's); candidates share a bucket in any table and
rank by euclidean distance. numpy on the host.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


class LSHIndex:
    def __init__(
        self,
        vectors: np.ndarray,
        ids: np.ndarray,
        bucket_length: float = 0.1,
        num_tables: int = 3,
        seed: int = 2024,
    ):
        self.vectors = np.asarray(vectors, np.float32)
        self.ids = np.asarray(ids)
        self.bucket_length = bucket_length
        d = self.vectors.shape[1]
        rng = np.random.default_rng(seed)
        w = rng.normal(size=(d, num_tables))
        self.proj = (w / np.linalg.norm(w, axis=0, keepdims=True)).astype(np.float32)
        self.buckets = np.floor(
            (self.vectors @ self.proj) / bucket_length
        ).astype(np.int64)  # [M, T]
        self._tables: List[Dict[int, np.ndarray]] = []
        for t in range(num_tables):
            table: Dict[int, List[int]] = {}
            for i, b in enumerate(self.buckets[:, t]):
                table.setdefault(int(b), []).append(i)
            self._tables.append({k: np.asarray(v) for k, v in table.items()})

    def query(self, vec: np.ndarray, k: int = 5) -> List[Tuple[int, float]]:
        """Approximate k nearest: (id, euclidean distance), ascending."""
        vec = np.asarray(vec, np.float32)
        qb = np.floor((vec @ self.proj) / self.bucket_length).astype(np.int64)
        cand: List[np.ndarray] = []
        for t, table in enumerate(self._tables):
            hit = table.get(int(qb[t]))
            if hit is not None:
                cand.append(hit)
        if not cand:
            return []
        idx = np.unique(np.concatenate(cand))
        dist = np.linalg.norm(self.vectors[idx] - vec, axis=1)
        top = np.argsort(dist, kind="stable")[:k]
        return [(int(self.ids[idx[i]]), float(dist[i])) for i in top]

"""Embedding artifacts in the reference's text format, `id:f f f ...` per
line (a copy of `sparrowrecsys_tpu/embedding/artifacts.py`): the files the
server's `emb` paths read (`item2vecEmb.csv`, `userEmb.csv`)."""

from __future__ import annotations

import os
from typing import Dict, Iterable

import numpy as np


def write_embeddings_csv(path: str, ids: Iterable, vectors: np.ndarray) -> None:
    """One `id:v v ...` line per row, each value as `str(float(x))`."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    vectors = np.asarray(vectors)
    with open(path, "w") as f:
        for i, vec in zip(ids, vectors):
            f.write(f"{i}:" + " ".join(str(float(x)) for x in vec) + "\n")


def load_embeddings_csv(path: str) -> Dict[int, np.ndarray]:
    """id -> float32 vector."""
    out: Dict[int, np.ndarray] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, _, rest = line.partition(":")
            out[int(key)] = np.array(rest.split(), dtype=np.float32)
    return out

"""Embedding artifacts in the reference's text format, `id:f f f ...` per
line (a copy of `sparrowrecsys_tpu/embedding/artifacts.py::load_embeddings_csv`)."""

from __future__ import annotations

from typing import Dict

import numpy as np


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

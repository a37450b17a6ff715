"""Online key-value feature store (the Redis role): the port of
`sparrowrecsys_tpu/serving/feature_store.py`, read side.

It holds the `mf:<movieId>` / `uf:<userId>` hashes the offline pipeline
exports to `feature_store.json`, with their TTLs. Serving only reads
them; the writers (`hset`, `export_sample_features`, the nearline
stream) and the string keys belong to planes not ported yet.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, Optional

MOVIE_FEATURE_PREFIX = "mf:"
USER_FEATURE_PREFIX = "uf:"


class FeatureStore:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hashes: Dict[str, Dict[str, str]] = {}
        self._expiry: Dict[str, float] = {}

    def hgetall(self, key: str) -> Optional[Dict[str, str]]:
        with self._lock:
            exp = self._expiry.get(key)
            if exp is not None and time.time() > exp:
                self._hashes.pop(key, None)
                self._expiry.pop(key, None)
                return None
            return dict(self._hashes[key]) if key in self._hashes else None

    @classmethod
    def load(cls, path: str) -> "FeatureStore":
        store = cls()
        with open(path) as f:
            blob = json.load(f)
        store._hashes = {k: dict(v) for k, v in blob.get("hashes", {}).items()}
        store._expiry = {k: float(v) for k, v in blob.get("expiry", {}).items()}
        return store

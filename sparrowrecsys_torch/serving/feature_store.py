"""Online key-value feature store (the Redis role): the port of
`sparrowrecsys_tpu/serving/feature_store.py`.

The offline feature job exports per-movie `mf:<movieId>` and per-user
`uf:<userId>` hashes (`export_sample_features`, the reference's
`extractAndSave{Movie,User}FeaturesToRedis`, scala:144-192, 239-296) with
a 30-day TTL; embeddings travel as `i2vEmb:`/`uEmb:` strings with a 24 h
TTL. TTLs are enforced on read (the reference builds TTL params but never
passes them to `hset`, scala:161-183). `save` writes the offline-to-online
hand-off file `feature_store.json`, absolute expiry epochs included, and
`load` reads it back.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

import numpy as np

MOVIE_FEATURE_PREFIX = "mf:"
USER_FEATURE_PREFIX = "uf:"
MOVIE_EMB_PREFIX = "i2vEmb:"
USER_EMB_PREFIX = "uEmb:"

MOVIE_FEATURE_TTL = 60 * 60 * 24 * 30  # 30 days (scala:163)
EMB_TTL = 60 * 60 * 24                 # 24 hours (Embedding.scala:157)


class FeatureStore:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hashes: Dict[str, Dict[str, str]] = {}
        self._strings: Dict[str, str] = {}
        self._expiry: Dict[str, float] = {}
        #: Write counter: caches derived from the store (the assembler's
        #: movie block) key on it, so any hset or set invalidates them.
        self.mutations = 0

    # ---- the Redis-shaped API ----------------------------------------------
    def hset(self, key: str, mapping: Dict[str, str], ttl: Optional[float] = None) -> None:
        with self._lock:
            self.mutations += 1
            self._hashes[key] = {k: str(v) for k, v in mapping.items()}
            self._set_expiry(key, ttl)

    def hgetall(self, key: str) -> Optional[Dict[str, str]]:
        with self._lock:
            if self._expired(key):
                return None
            return dict(self._hashes[key]) if key in self._hashes else None

    def set(self, key: str, value: str, ttl: Optional[float] = None) -> None:
        with self._lock:
            self.mutations += 1
            self._strings[key] = value
            self._set_expiry(key, ttl)

    def get(self, key: str) -> Optional[str]:
        with self._lock:
            if self._expired(key):
                return None
            return self._strings.get(key)

    def _set_expiry(self, key: str, ttl: Optional[float]) -> None:
        if ttl:
            self._expiry[key] = time.time() + ttl
        else:
            # Redis SET/HSET without a TTL clears any earlier expiry.
            self._expiry.pop(key, None)

    def _expired(self, key: str) -> bool:
        exp = self._expiry.get(key)
        if exp is not None and time.time() > exp:
            self._hashes.pop(key, None)
            self._strings.pop(key, None)
            self._expiry.pop(key, None)
            return True
        return False

    # ---- persistence: the offline -> online hand-off file -------------------
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with self._lock:
            # Copied under the lock; json.dump runs outside it.
            blob = {
                "hashes": {k: dict(v) for k, v in self._hashes.items()},
                "strings": dict(self._strings),
                "expiry": dict(self._expiry),
            }
        with open(path, "w") as f:
            json.dump(blob, f)

    @classmethod
    def load(cls, path: str) -> "FeatureStore":
        store = cls()
        with open(path) as f:
            blob = json.load(f)
        store._hashes = {k: dict(v) for k, v in blob.get("hashes", {}).items()}
        store._strings = dict(blob.get("strings", {}))
        store._expiry = {k: float(v) for k, v in blob.get("expiry", {}).items()}
        return store


def _latest_rows(ids: np.ndarray, ts: np.ndarray) -> Dict[int, int]:
    """{id: row of its latest sample}, the reference's row_number() == 1
    window (scala:146-151, 241-247): a stable sort by (id, timestamp),
    then each id group's last row."""
    ids = np.asarray(ids)
    order = np.lexsort((np.arange(len(ids)), ts, ids))
    ids_s = ids[order]
    last = np.flatnonzero(np.concatenate([ids_s[1:] != ids_s[:-1], [True]]))
    return {int(ids_s[i]): int(order[i]) for i in last}


def export_sample_features(table, genre_vocab, store: FeatureStore) -> None:
    """Write the `mf:` and `uf:` hashes of a SampleTable's latest row per
    movie and per user, with the 30-day TTL."""
    ts = np.asarray(table["timestamp"])

    def genre_str(v: int) -> str:
        return genre_vocab[v] if v >= 0 else ""

    for mid, i in _latest_rows(table["movieId"], ts).items():
        store.hset(
            f"{MOVIE_FEATURE_PREFIX}{mid}",
            {
                "movieGenre1": genre_str(int(table["movieGenre1"][i])),
                "movieGenre2": genre_str(int(table["movieGenre2"][i])),
                "movieGenre3": genre_str(int(table["movieGenre3"][i])),
                "movieRatingCount": str(int(table["movieRatingCount"][i])),
                "releaseYear": str(int(table["releaseYear"][i])),
                "movieAvgRating": f"{float(table['movieAvgRating'][i]):.2f}",
                "movieRatingStddev": f"{float(table['movieRatingStddev'][i]):.2f}",
            },
            ttl=MOVIE_FEATURE_TTL,
        )
    for uid, i in _latest_rows(table["userId"], ts).items():
        mapping = {
            "userRatingCount": str(int(table["userRatingCount"][i])),
            "userAvgReleaseYear": str(int(table["userAvgReleaseYear"][i])),
            "userReleaseYearStddev": f"{float(table['userReleaseYearStddev'][i]):.2f}",
            "userAvgRating": f"{float(table['userAvgRating'][i]):.2f}",
            "userRatingStddev": f"{float(table['userRatingStddev'][i]):.2f}",
        }
        for k in range(1, 6):
            v = int(table[f"userRatedMovie{k}"][i])
            mapping[f"userRatedMovie{k}"] = str(v) if v > 0 else ""
        for k in range(1, 6):
            mapping[f"userGenre{k}"] = genre_str(int(table[f"userGenre{k}"][i]))
        store.hset(f"{USER_FEATURE_PREFIX}{uid}", mapping, ttl=MOVIE_FEATURE_TTL)

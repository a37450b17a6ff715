"""Online feature assembly: the port of `sparrowrecsys_tpu/serving/assembler.py`.

Given (user_id, candidate movie_ids) it assembles the zoo's full feature
dict from the `mf:`/`uf:` feature store, with the catalog as fallback for
the movie side, encoded as the offline pipeline encodes samples: genre
string -> 19-vocab index with -1 for OOV or missing, history '' -> 0,
numerics float.

Nearline: when the stream (`nearline/stream.py::attach_to_store`) has
recorded a fresher positive event for the user, the assembler shifts
its movie into `userRatedMovie1` (history most-recent-first,
`FeatureEngForRecModel.scala:99-107`), so the model sees behaviour the
offline snapshot predates. The movie-block cache is keyed on the
candidate ids, the store's write counter and the candidates' total
rating count, so a store write or a catalog `add_rating` rebuilds it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from sparrowrecsys_torch.config import GENRE_VOCAB
from sparrowrecsys_torch.data.schema import HISTORY_COLUMNS
from sparrowrecsys_torch.serving.feature_store import (
    FeatureStore,
    MOVIE_FEATURE_PREFIX,
    USER_FEATURE_PREFIX,
)

_GENRE_TO_IDX = {g: i for i, g in enumerate(GENRE_VOCAB)}

#: Only ratings >= 3.5 enter the behaviour history (`addSampleLabel`,
#: FeatureEngForRecModel.scala:27-37).
_POSITIVE_RATING = 3.5

USER_INT_COLS = tuple(HISTORY_COLUMNS)
USER_GENRE_COLS = ("userGenre1", "userGenre2", "userGenre3", "userGenre4",
                   "userGenre5")
USER_FLOAT_COLS = ("userRatingCount", "userAvgRating", "userRatingStddev",
                   "userAvgReleaseYear", "userReleaseYearStddev")
MOVIE_GENRE_COLS = ("movieGenre1", "movieGenre2", "movieGenre3")
MOVIE_FLOAT_COLS = ("releaseYear", "movieRatingCount", "movieAvgRating",
                    "movieRatingStddev")


def _genre_idx(s: Optional[str]) -> int:
    return _GENRE_TO_IDX.get(s, -1) if s else -1


def _f(s: Optional[str]) -> float:
    try:
        return float(s) if s not in (None, "") else 0.0
    except ValueError:
        return 0.0


def _i(s: Optional[str]) -> int:
    try:
        return int(float(s)) if s not in (None, "") else 0
    except ValueError:
        return 0


class FeatureAssembler:
    """Assembles the online feature dict for one user x N candidates.

    store: the `mf:`/`uf:` FeatureStore; dm: optional DataManager for the
    movie-side catalog fallback when a movie has no `mf:` hash and for the
    nearline real-time history shift."""

    def __init__(self, store: FeatureStore, dm=None) -> None:
        self.store = store
        self.dm = dm
        # Every ranked request re-assembles the same top-800 candidate
        # rows, so the movie block is cached as one (key, block) tuple:
        # one assignment, safe across threads.
        self._movie_block = (None, None)

    def user_row(self, user_id: int) -> Dict[str, float]:
        h = self.store.hgetall(f"{USER_FEATURE_PREFIX}{user_id}") or {}
        row: Dict[str, float] = {}
        for c in USER_INT_COLS:
            row[c] = _i(h.get(c))
        for c in USER_GENRE_COLS:
            row[c] = _genre_idx(h.get(c))
        for c in USER_FLOAT_COLS:
            row[c] = _f(h.get(c))
        if self.dm is not None:
            self._apply_realtime(user_id, row)
        return row

    def _apply_realtime(self, user_id: int, row: Dict[str, float]) -> None:
        """Shift the stream's latest positive event into userRatedMovie1;
        not for a rating under 3.5, nor when that movie is already first."""
        user = self.dm.get_user_by_id(user_id)
        feats = user.user_features if user is not None else None
        if not feats:
            return
        latest = _i(feats.get("latestMovieId"))
        if latest <= 0 or latest == row[HISTORY_COLUMNS[0]]:
            return
        rating = feats.get("latestMovieRating")
        if rating not in (None, "") and _f(rating) < _POSITIVE_RATING:
            return
        for k in range(len(HISTORY_COLUMNS) - 1, 0, -1):
            row[HISTORY_COLUMNS[k]] = row[HISTORY_COLUMNS[k - 1]]
        row[HISTORY_COLUMNS[0]] = latest

    def movie_row(self, movie_id: int) -> Dict[str, float]:
        h = self.store.hgetall(f"{MOVIE_FEATURE_PREFIX}{movie_id}")
        if h:
            row: Dict[str, float] = {c: _genre_idx(h.get(c)) for c in MOVIE_GENRE_COLS}
            for c in MOVIE_FLOAT_COLS:
                row[c] = _f(h.get(c))
            return row
        # Catalog fallback: genres, year, count and average are tracked by
        # the DataManager; the stddev is not derivable incrementally.
        row = {c: -1 for c in MOVIE_GENRE_COLS}
        row.update({c: 0.0 for c in MOVIE_FLOAT_COLS})
        m = self.dm.get_movie_by_id(movie_id) if self.dm is not None else None
        if m is not None:
            for k, g in enumerate(m.genres[:3]):
                row[MOVIE_GENRE_COLS[k]] = _genre_idx(g)
            row["releaseYear"] = float(m.release_year)
            row["movieRatingCount"] = float(m.rating_number)
            row["movieAvgRating"] = float(m.average_rating)
        return row

    def features(self, user_id: int, movie_ids: Sequence[int],
                 extra_int_cols: Sequence[str] = ()) -> Dict[str, np.ndarray]:
        """Full feature dict for scoring `movie_ids` for `user_id`: int32
        ids, history and genre indices, float32 numerics. `extra_int_cols`
        adds zero int32 columns (DIEN's negative history, which only its
        training-time aux heads read)."""
        n = len(movie_ids)
        u = self.user_row(int(user_id))
        feats: Dict[str, np.ndarray] = {
            "movieId": np.asarray(movie_ids, np.int32),
            "userId": np.full(n, int(user_id), np.int32),
        }
        for c in USER_INT_COLS + USER_GENRE_COLS:
            feats[c] = np.full(n, int(u[c]), np.int32)
        for c in USER_FLOAT_COLS:
            feats[c] = np.full(n, float(u[c]), np.float32)
        mg, mf = self.movie_block(movie_ids)
        for k, c in enumerate(MOVIE_GENRE_COLS):
            feats[c] = mg[:, k]
        for k, c in enumerate(MOVIE_FLOAT_COLS):
            feats[c] = mf[:, k]
        for c in extra_int_cols:
            feats[c] = np.zeros(n, np.int32)
        return feats

    def movie_block(self, movie_ids: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        """([n, 3] int32 genre indices, [n, 4] float32 numerics), cached
        until the store or the candidates' ratings change."""
        ids = tuple(int(m) for m in movie_ids)
        stat = 0
        if self.dm is not None:
            for mid in ids:
                m = self.dm.get_movie_by_id(mid)
                if m is not None:
                    stat += m.rating_number
        key = (ids, self.store.mutations, stat)
        cached, block = self._movie_block
        if cached == key:
            return block
        n = len(ids)
        mg = np.full((n, len(MOVIE_GENRE_COLS)), -1, np.int32)
        mf = np.zeros((n, len(MOVIE_FLOAT_COLS)), np.float32)
        for j, mid in enumerate(ids):
            row = self.movie_row(mid)
            for k, c in enumerate(MOVIE_GENRE_COLS):
                mg[j, k] = int(row[c])
            for k, c in enumerate(MOVIE_FLOAT_COLS):
                mf[j, k] = float(row[c])
        mg.setflags(write=False)
        mf.setflags(write=False)
        self._movie_block = (key, (mg, mf))
        return mg, mf

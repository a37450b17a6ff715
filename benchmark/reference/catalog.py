"""The `/getrecforyou` candidate set and DIN's features, worked out from
the data files as SparrowRecSys defines them.

- The catalog: `movies.csv` (title with a `(YYYY)` suffix, else the
  year 1990; genres split on "|"), each movie's average rating over
  `ratings.csv`, kept as a running average in file order
  (`Movie.addRating` of the Java reference), and the users who rated.
- The candidates: every movie ranked by its average rating, highest
  first, ties in file order (a stable sort), the first 800
  (`RecForYouProcess.java:35`).
- The features: the offline job's `uf:<userId>` and `mf:<movieId>`
  hashes in `feature_store.json`; a movie without one takes its first
  genres, year, rating count and average from the catalog, and a
  standard deviation of 0. Genres map onto the 19-genre vocabulary, -1
  where missing or unknown; an empty history slot is movie 0.

Imports numpy and nothing of the program.
"""

from __future__ import annotations

import csv
import json
import os
import re
from typing import Dict, List

import numpy as np

GENRE_VOCAB = (
    "Film-Noir", "Action", "Adventure", "Horror", "Romance", "War", "Comedy",
    "Western", "Documentary", "Sci-Fi", "Drama", "Thriller", "Crime",
    "Fantasy", "Animation", "IMAX", "Mystery", "Children", "Musical",
)
_GENRE = {g: i for i, g in enumerate(GENRE_VOCAB)}
_YEAR = re.compile(r"\((\d{4})\)\s*$")
CANDIDATES = 800
HISTORY = 5
USER_NUMERICS = ("userRatingCount", "userAvgRating", "userRatingStddev")


def _genre(s) -> int:
    return _GENRE.get(s, -1) if s else -1


def _float(s) -> float:
    try:
        return float(s) if s not in (None, "") else 0.0
    except ValueError:
        return 0.0


def _int(s) -> int:
    try:
        return int(float(s)) if s not in (None, "") else 0
    except ValueError:
        return 0


class Catalog:
    """Movies, their rating statistics, the users, and the feature hashes
    of one data root."""

    def __init__(self, data_root: str):
        self.movies: Dict[int, dict] = {}
        with open(os.path.join(data_root, "movies.csv"), newline="", encoding="utf-8") as f:
            rows = list(csv.reader(f))[1:]
        for row in rows:
            title = row[1].strip()
            m = _YEAR.search(title)
            year = int(m.group(1)) if m is not None and len(title) >= 6 else 1990
            genres = [g for g in row[2].split("|")] if len(row) > 2 and row[2] else []
            self.movies[int(row[0])] = {"year": year, "genres": [g for g in genres if g],
                                        "n": 0, "avg": 0.0}
        self.users: List[int] = []
        seen = set()
        with open(os.path.join(data_root, "ratings.csv"), newline="") as f:
            for row in list(csv.reader(f))[1:]:
                uid, mid, score = int(row[0]), int(row[1]), float(row[2])
                mv = self.movies.get(mid)
                if mv is not None:
                    mv["avg"] = (mv["avg"] * mv["n"] + score) / (mv["n"] + 1)
                    mv["n"] += 1
                if uid not in seen:
                    seen.add(uid)
                    self.users.append(uid)
        with open(os.path.join(data_root, "feature_store.json")) as f:
            self.hashes: Dict[str, Dict[str, str]] = json.load(f).get("hashes", {})

    def candidates(self) -> List[int]:
        ids = list(self.movies)
        return sorted(ids, key=lambda m: self.movies[m]["avg"], reverse=True)[:CANDIDATES]

    def user_columns(self, user_id: int) -> Dict[str, float]:
        h = self.hashes.get(f"uf:{user_id}") or {}
        row: Dict[str, float] = {"userId": user_id}
        for k in range(1, HISTORY + 1):
            row[f"userRatedMovie{k}"] = _int(h.get(f"userRatedMovie{k}"))
        row["userGenre1"] = _genre(h.get("userGenre1"))
        for c in USER_NUMERICS:
            row[c] = _float(h.get(c))
        return row

    def movie_columns(self, movie_id: int) -> Dict[str, float]:
        h = self.hashes.get(f"mf:{movie_id}")
        if h:
            row = {"movieGenre1": _genre(h.get("movieGenre1"))}
            for c in ("releaseYear", "movieRatingCount", "movieAvgRating", "movieRatingStddev"):
                row[c] = _float(h.get(c))
            return row
        mv = self.movies[movie_id]
        return {"movieGenre1": _genre(mv["genres"][0]) if mv["genres"] else -1,
                "releaseYear": float(mv["year"]), "movieRatingCount": float(mv["n"]),
                "movieAvgRating": float(mv["avg"]), "movieRatingStddev": 0.0}

    def request_columns(self, user_ids: List[int], movie_ids: List[int]) -> Dict[str, np.ndarray]:
        """The columns of every (user, candidate) pair, users major: int32
        ids and genres, float32 numerics."""
        n, k = len(movie_ids), len(user_ids)
        movies = [self.movie_columns(m) for m in movie_ids]
        users = [self.user_columns(u) for u in user_ids]
        cols: Dict[str, np.ndarray] = {}
        for c in users[0]:
            dtype = np.float32 if c in USER_NUMERICS else np.int32
            cols[c] = np.repeat(np.asarray([u[c] for u in users], dtype), n)
        for c in movies[0]:
            dtype = np.int32 if c == "movieGenre1" else np.float32
            cols[c] = np.tile(np.asarray([m[c] for m in movies], dtype), k)
        cols["movieId"] = np.tile(np.asarray(movie_ids, np.int32), k)
        return cols

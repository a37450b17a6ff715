"""MovieLens CSV loaders and writers: copies of
`sparrowrecsys_tpu/data/movielens.py`.

`load_ratings` is a numpy parser (the JAX package's `--native` C++
loader is not ported). `write_ratings_csv` writes what the JAX package
writes without pandas (its pandas branch writes "3.0" for a rating of 3;
`data/ratings.csv` has "3").
"""

from __future__ import annotations

import csv
import dataclasses
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

_YEAR_RE = re.compile(r"\((\d{4})\)\s*$")

#: Year when a title has no parseable `(YYYY)` suffix.
DEFAULT_RELEASE_YEAR = 1990


@dataclasses.dataclass
class MovieCatalog:
    """Columnar movie table (id, cleaned title, release year, genres)."""

    movie_ids: np.ndarray              # int32 [M]
    titles: List[str]
    release_years: np.ndarray          # int32 [M]
    genres: List[List[str]]
    #: movieId -> row; built from movie_ids when not given
    id_to_row: Optional[Dict[int, int]] = None

    def __post_init__(self) -> None:
        if self.id_to_row is None:
            self.id_to_row = {int(m): i for i, m in enumerate(self.movie_ids)}

    def __len__(self) -> int:
        return len(self.movie_ids)

    def row(self, movie_id: int) -> Optional[int]:
        return self.id_to_row.get(int(movie_id))


def parse_release_year(title: str) -> Tuple[str, int]:
    """'Toy Story (1995)' -> ('Toy Story', 1995); no suffix -> 1990."""
    title = title.strip()
    m = _YEAR_RE.search(title)
    if m is None or len(title) < 6:
        return title, DEFAULT_RELEASE_YEAR
    return title[: m.start()].strip(), int(m.group(1))


def _read_csv(path: str) -> List[List[str]]:
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f))
    return rows[1:]  # drop header


def load_movies(path: str) -> MovieCatalog:
    rows = _read_csv(path)
    movie_ids = np.empty(len(rows), dtype=np.int32)
    years = np.empty(len(rows), dtype=np.int32)
    titles: List[str] = []
    genres: List[List[str]] = []
    for i, row in enumerate(rows):
        title, year = parse_release_year(row[1])
        movie_ids[i] = int(row[0])
        titles.append(title)
        years[i] = year
        genres.append(row[2].split("|") if len(row) > 2 and row[2] else [])
    return MovieCatalog(movie_ids, titles, years, genres)


def load_links(path: str) -> Dict[int, Tuple[str, str]]:
    """movieId -> (imdbId, tmdbId)."""
    return {int(r[0]): (r[1], r[2]) for r in _read_csv(path) if len(r) >= 3}


@dataclasses.dataclass
class Ratings:
    """Columnar rating events."""

    user_ids: np.ndarray   # int32 [N]
    movie_ids: np.ndarray  # int32 [N]
    ratings: np.ndarray    # float32 [N]
    timestamps: np.ndarray # int64 [N]

    def __len__(self) -> int:
        return len(self.user_ids)


def load_ratings(path: str) -> Ratings:
    """Parse a `userId,movieId,rating,timestamp` CSV with a header."""
    rows = np.loadtxt(
        path, delimiter=",", skiprows=1, ndmin=1,
        dtype=[("u", np.int32), ("m", np.int32), ("r", np.float32), ("t", np.int64)],
    )
    return Ratings(rows["u"].copy(), rows["m"].copy(), rows["r"].copy(),
                   rows["t"].copy())


def ratings_from_samples_csv(path: str) -> Ratings:
    """Recover the rating events from a 27-column sample CSV: its first
    four columns are genuine (movieId, userId, rating, timestamp) events.
    Duplicate (user, movie, timestamp) triples are dropped, first kept."""
    rows = _read_csv(path)
    n = len(rows)
    u = np.empty(n, dtype=np.int32)
    m = np.empty(n, dtype=np.int32)
    r = np.empty(n, dtype=np.float32)
    t = np.empty(n, dtype=np.int64)
    for i, row in enumerate(rows):
        m[i] = int(row[0])
        u[i] = int(row[1])
        r[i] = float(row[2])
        t[i] = int(row[3])
    key = np.stack([u.astype(np.int64), m.astype(np.int64), t], axis=1)
    _, first = np.unique(key, axis=0, return_index=True)
    keep = np.sort(first)
    return Ratings(u[keep], m[keep], r[keep], t[keep])


def write_ratings_csv(ratings: Ratings, path: str) -> None:
    """`userId,movieId,rating,timestamp` with a header; a rating as "%g"."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["userId", "movieId", "rating", "timestamp"])
        for i in range(len(ratings)):
            w.writerow([int(ratings.user_ids[i]), int(ratings.movie_ids[i]),
                        f"{float(ratings.ratings[i]):g}", int(ratings.timestamps[i])])

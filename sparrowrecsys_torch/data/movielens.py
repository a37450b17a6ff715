"""MovieLens CSV loaders the serving catalog needs.

Copies of `sparrowrecsys_tpu/data/movielens.py::load_movies` and
`load_links`, and `load_ratings`, a numpy parser that takes the place of
the JAX package's C++ loader (`native.load_ratings_native`), whose
library is built on demand and not part of a checkout.
"""

from __future__ import annotations

import csv
import dataclasses
import re
from typing import Dict, List, Tuple

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

    def __len__(self) -> int:
        return len(self.movie_ids)


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

"""In-memory catalog: the port of `sparrowrecsys_tpu/serving/catalog.py`.

`DataManager` loads movies (title, year, genres, genre index), links,
ratings (incremental per-movie averages and top ratings, per-user
stats) and the movie/user embedding files, and serves the query API of
the endpoints. The embeddings are also kept as aligned matrices so the
rankers score a whole candidate set with one matmul.

The entities' JSON, including the `{"rating": {...}}` wrapper, is
byte-identical to the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import numpy as np

from sparrowrecsys_torch.data.movielens import load_links, load_movies, load_ratings
from sparrowrecsys_torch.embedding.artifacts import load_embeddings_csv

TOP_RATING_SIZE = 10


@dataclasses.dataclass
class Rating:
    movie_id: int
    user_id: int
    score: float
    timestamp: int

    def to_json(self) -> dict:
        return {
            "movieId": self.movie_id,
            "userId": self.user_id,
            "score": self.score,
            "timestamp": self.timestamp,
        }


def _wrap_ratings(ratings: List[Rating]) -> list:
    return [{"rating": r.to_json()} for r in ratings]


@dataclasses.dataclass
class Movie:
    movie_id: int
    title: str = ""
    release_year: int = 0
    imdb_id: str = ""
    tmdb_id: str = ""
    genres: List[str] = dataclasses.field(default_factory=list)
    rating_number: int = 0
    average_rating: float = 0.0
    top_ratings: List[Rating] = dataclasses.field(default_factory=list)
    emb: Optional[np.ndarray] = None
    #: serialized `to_json()`, cached until the next add_rating.
    _json_cache: Optional[str] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def add_rating(self, rating: Rating) -> None:
        """Incremental average + bounded top-10 insert, sorted descending."""
        self._json_cache = None
        self.average_rating = (
            self.average_rating * self.rating_number + rating.score
        ) / (self.rating_number + 1)
        self.rating_number += 1
        lo, hi = 0, len(self.top_ratings)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.top_ratings[mid].score >= rating.score:
                lo = mid + 1
            else:
                hi = mid
        self.top_ratings.insert(lo, rating)
        if len(self.top_ratings) > TOP_RATING_SIZE:
            self.top_ratings.pop()

    def to_json(self) -> dict:
        return {
            "movieId": self.movie_id,
            "title": self.title,
            "releaseYear": self.release_year,
            "imdbId": self.imdb_id,
            "tmdbId": self.tmdb_id,
            "genres": self.genres,
            "ratingNumber": self.rating_number,
            "averageRating": self.average_rating,
            "topRatings": _wrap_ratings(self.top_ratings),
        }

    def to_json_str(self) -> str:
        if self._json_cache is None:
            self._json_cache = json.dumps(self.to_json())
        return self._json_cache


@dataclasses.dataclass
class User:
    user_id: int
    ratings: List[Rating] = dataclasses.field(default_factory=list)
    average_rating: float = 0.0
    highest_rating: float = 0.0
    lowest_rating: float = 5.0
    rating_count: int = 0
    emb: Optional[np.ndarray] = None
    #: the `uf:` features the nearline stream writes (`latestMovieId`,
    #: `latestMovieRating`), which the assembler's real-time shift reads
    user_features: Optional[Dict[str, str]] = None

    def add_rating(self, rating: Rating) -> None:
        self.ratings.append(rating)
        self.average_rating = (
            self.average_rating * self.rating_count + rating.score
        ) / (self.rating_count + 1)
        self.highest_rating = max(self.highest_rating, rating.score)
        self.lowest_rating = min(self.lowest_rating, rating.score)
        self.rating_count += 1

    def to_json(self) -> dict:
        return {
            "userId": self.user_id,
            "ratings": _wrap_ratings(self.ratings),
            "averageRating": self.average_rating,
            "highestRating": self.highest_rating,
            "lowestRating": self.lowest_rating,
            "ratingCount": self.rating_count,
        }


class DataManager:
    """Loads everything once; read-only afterwards, so the HTTP worker
    threads share it without locks."""

    def __init__(self) -> None:
        self.movies: Dict[int, Movie] = {}
        self.users: Dict[int, User] = {}
        self.genre_index: Dict[str, List[Movie]] = {}
        self.movie_emb_matrix: np.ndarray = np.zeros((0, 0), np.float32)
        self.user_emb_matrix: np.ndarray = np.zeros((0, 0), np.float32)
        self._movie_emb_row: Dict[int, int] = {}
        self._user_emb_row: Dict[int, int] = {}

    def load_data(
        self,
        movies_csv: str,
        links_csv: Optional[str],
        ratings_csv: Optional[str],
        movie_emb_csv: Optional[str],
        user_emb_csv: Optional[str],
    ) -> "DataManager":
        self._load_movies(movies_csv)
        if links_csv:
            self._load_links(links_csv)
        if ratings_csv:
            self._load_ratings(ratings_csv)
        if movie_emb_csv:
            self.movie_emb_matrix, self._movie_emb_row = self._load_emb(
                movie_emb_csv, self.movies)
            print(f"Loading movie embedding completed. "
                  f"{len(self._movie_emb_row)} movie embeddings.")
        if user_emb_csv:
            self.user_emb_matrix, self._user_emb_row = self._load_emb(
                user_emb_csv, self.users)
            print(f"Loading user embedding completed. "
                  f"{len(self._user_emb_row)} user embeddings.")
        return self

    def _load_movies(self, path: str) -> None:
        catalog = load_movies(path)
        for i in range(len(catalog)):
            mid = int(catalog.movie_ids[i])
            genres = [g for g in catalog.genres[i] if g]
            m = Movie(mid, catalog.titles[i], int(catalog.release_years[i]),
                      genres=genres)
            self.movies[mid] = m
            for g in genres:
                self.genre_index.setdefault(g, []).append(m)
        print(f"Loading movie data completed. {len(self.movies)} movies in total.")

    def _load_links(self, path: str) -> None:
        for mid, (imdb, tmdb) in load_links(path).items():
            m = self.movies.get(mid)
            if m is not None:
                m.imdb_id, m.tmdb_id = imdb, tmdb

    def _load_ratings(self, path: str) -> None:
        ratings = load_ratings(path)
        for i in range(len(ratings)):
            uid, mid = int(ratings.user_ids[i]), int(ratings.movie_ids[i])
            r = Rating(mid, uid, float(ratings.ratings[i]), int(ratings.timestamps[i]))
            movie = self.movies.get(mid)
            if movie is not None:
                movie.add_rating(r)
            if uid not in self.users:
                self.users[uid] = User(uid)
            self.users[uid].add_rating(r)
        print(f"Loading rating data completed. {len(ratings)} ratings in total.")

    @staticmethod
    def _load_emb(path: str, entities: dict):
        """Attach vectors to entities; return the aligned matrix and the
        id -> row map (file order)."""
        embs = load_embeddings_csv(path)
        for eid, vec in embs.items():
            e = entities.get(eid)
            if e is not None:
                e.emb = vec
        rows = list(embs.values())
        matrix = (np.stack(rows).astype(np.float32) if rows
                  else np.zeros((0, 0), np.float32))
        return matrix, {int(i): r for r, i in enumerate(embs)}

    # ---- query API -------------------------------------------------------
    def get_movies_by_genre(self, genre: str, size: int, sort_by: str = "rating") -> List[Movie]:
        """Raises KeyError on an unknown genre; the endpoint's catch-all
        turns it into the reference's empty response."""
        movies = list(self.genre_index[genre])
        self._sort(movies, sort_by)
        return movies[:size]

    def get_movies(self, size: int, sort_by: str = "rating") -> List[Movie]:
        movies = list(self.movies.values())
        self._sort(movies, sort_by)
        return movies[:size]

    @staticmethod
    def _sort(movies: List[Movie], sort_by: str) -> None:
        if sort_by == "rating":
            movies.sort(key=lambda m: m.average_rating, reverse=True)
        elif sort_by == "releaseYear":
            movies.sort(key=lambda m: m.release_year, reverse=True)

    def get_movie_by_id(self, movie_id: int) -> Optional[Movie]:
        return self.movies.get(movie_id)

    def get_user_by_id(self, user_id: int) -> Optional[User]:
        return self.users.get(user_id)

    def movie_emb_row(self, movie_id: int) -> int:
        return self._movie_emb_row.get(movie_id, -1)

    def user_emb_row(self, user_id: int) -> int:
        return self._user_emb_row.get(user_id, -1)

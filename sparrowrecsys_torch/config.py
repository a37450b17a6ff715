"""Constants and configuration used by the port's serving plane.

A copy of the parts of `sparrowrecsys_tpu/config.py` this package needs
(the port imports nothing of the JAX package). Values are identical:
the exported checkpoints and the feature encoding depend on them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

#: 19-genre vocabulary, in the reference's order (`EmbeddingMLP.py:30-32`).
GENRE_VOCAB: Tuple[str, ...] = (
    "Film-Noir", "Action", "Adventure", "Horror", "Romance", "War", "Comedy",
    "Western", "Documentary", "Sci-Fi", "Drama", "Thriller", "Crime",
    "Fantasy", "Animation", "IMAX", "Mystery", "Children", "Musical",
)

#: movieId id-space (`EmbeddingMLP.py:57`).
MOVIE_VOCAB_SIZE = 1001
#: userId id-space (`EmbeddingMLP.py:62`).
USER_VOCAB_SIZE = 30001
#: every embedding in the reference zoo is 10-dim.
EMBEDDING_DIM = 10


def _default_data_root() -> str:
    return os.environ.get(
        "SPARROW_DATA_ROOT",
        os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data"
        ),
    )


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Paths of the serving plane's inputs under one data root."""

    data_root: str = dataclasses.field(default_factory=_default_data_root)
    movies_csv: str = "movies.csv"
    links_csv: str = "links.csv"
    ratings_csv: str = "ratings.csv"
    item_emb_file: str = "item2vecEmb.csv"
    user_emb_file: str = "userEmb.csv"

    def path(self, name: str) -> str:
        return os.path.join(self.data_root, name)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Online-serving parameters; the JAX package's defaults. Its fields
    that no code reads (candidate_size, webroot, ...) are not copied."""

    port: int = 6010
    #: micro-batcher window (ms) for coalescing concurrent ranked requests;
    #: 0 scores whatever is pending as soon as the previous wave ends.
    batch_wait_ms: float = 0.0
    #: concurrent full-feature ranked requests per model wave.
    model_batch: int = 8
    #: model-version poll interval in seconds; 0 disables hot reload.
    model_poll_s: float = 1.0
    #: shed requests with 503 beyond this many in-flight handlers (0 = off).
    max_inflight: int = 32

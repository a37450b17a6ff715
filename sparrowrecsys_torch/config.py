"""Constants and configuration of the port's serving and training planes.

A copy of the parts of `sparrowrecsys_tpu/config.py` this package needs
(the port imports nothing of the JAX package). Values are identical:
the exported checkpoints, the feature encoding and the training recipe
depend on them.
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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop parameters; every field and default of the JAX
    package's `TrainConfig` (`config.py:108-168`).

    Reference defaults: batch=12, adam, BCE, 5 epochs
    (`EmbeddingMLP.py:14-22,87-93`). batch=12 is kept as the parity
    setting; the default is a large batch.
    """

    batch_size: int = 8192
    parity_batch_size: int = 12
    epochs: int = 5
    learning_rate: float = 1e-3
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-7          # Keras Adam epsilon (TF default), not optax's 1e-8
    #: bfloat16 storage for the big tables with float32 master weights.
    #: Not ported yet (ROADMAP.md): True raises NotImplementedError.
    bf16_table_params: bool = False
    #: In the JAX package, routes the lazy row-Adam's row write through
    #: the Pallas row-DMA kernel. Kept for config parity; the port's
    #: row-Adam always moves its rows through the row kernels
    #: (`ops/rowio.py`) on the card, because the values are the same
    #: either way (`row_optim.py:178-186`).
    sparse_rowio: bool = False
    #: Storage dtype of the big leaves' Adam moments. Only "float32" is
    #: ported (ROADMAP.md); any other raises NotImplementedError.
    big_moment_dtype: str = "float32"
    shuffle_each_epoch: bool = True
    #: "exact" permutes rows; "blocks" (the JAX package's TPU layout
    #: option, fixed blocks of `shuffle_block` rows) is not ported yet: the
    #: Trainer raises NotImplementedError for it (ROADMAP.md).
    shuffle_mode: str = "exact"
    shuffle_block: int = 1024
    #: lax.scan unroll of the JAX package's resident epoch; no meaning
    #: for the port's eager loop, kept for config parity.
    epoch_unroll: int = 1
    seed: int = 42
    checkpoint_dir: str = "checkpoints"
    checkpoint_keep: int = 5        # reference keeps numbered versions 001..005

    def __post_init__(self) -> None:
        if self.shuffle_mode not in ("exact", "blocks"):
            raise ValueError(
                f"shuffle_mode={self.shuffle_mode!r}: expected 'exact' or 'blocks'"
            )
        if self.bf16_table_params:
            raise NotImplementedError(
                "bf16_table_params is not ported yet; it is queued in ROADMAP.md"
            )
        if self.big_moment_dtype != "float32":
            raise NotImplementedError(
                f"big_moment_dtype={self.big_moment_dtype!r} is not ported yet; "
                "it is queued in ROADMAP.md"
            )

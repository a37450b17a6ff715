"""Constants and the typed configuration tree of the port.

A copy of `sparrowrecsys_tpu/config.py` (the port imports nothing of the
JAX package): the same constants, the same sections (`DataConfig`,
`ModelConfig`, `MeshConfig`, `TrainConfig`, `ServingConfig` under
`SparrowConfig`) with the same field names, types and defaults, so a
file written by either package's `config_to_json` loads in the other.
The exported checkpoints, the feature encoding and the training recipe
depend on these values.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

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
#: behaviour-history length, `RECENT_MOVIES = 5` (`DIN.py:31`).
RECENT_MOVIES = 5
#: positive-label threshold, `rating >= 3.5` (`FeatureEngForRecModel.scala:36`).
POSITIVE_RATING_THRESHOLD = 3.5
#: trailing feature window, `rowsBetween(-100, -1)`
#: (`FeatureEngForRecModel.scala:100`).
USER_FEATURE_WINDOW = 100
#: decimal precision of the formatted statistics (`FeatureEngForRecModel.scala:17`).
NUMBER_PRECISION = 2


def _default_data_root() -> str:
    return os.environ.get(
        "SPARROW_DATA_ROOT",
        os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data"
        ),
    )


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Paths under one data root, and the feature job's sampling and split
    (`FeatureEngForRecModel.scala:195-212`)."""

    data_root: str = dataclasses.field(default_factory=_default_data_root)
    movies_csv: str = "movies.csv"
    links_csv: str = "links.csv"
    ratings_csv: str = "ratings.csv"
    item_emb_file: str = "item2vecEmb.csv"
    user_emb_file: str = "userEmb.csv"
    sample_fraction: float = 1.0
    train_fraction: float = 0.8
    #: split at the train_fraction quantile of timestamps instead of at random
    split_by_time: bool = False
    seed: int = 2024

    def path(self, name: str) -> str:
        return os.path.join(self.data_root, name)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Shared model hyper-parameters (per-model extras live in the model)."""

    movie_vocab_size: int = MOVIE_VOCAB_SIZE
    user_vocab_size: int = USER_VOCAB_SIZE
    embedding_dim: int = EMBEDDING_DIM
    genre_vocab_size: int = len(GENRE_VOCAB)
    recent_movies: int = RECENT_MOVIES
    #: cross-feature hash buckets, `crossed_column(..., 10000)` (`WideNDeep.py:75`)
    cross_hash_buckets: int = 10000
    #: compute dtype of the dense towers; params stay float32
    compute_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The device mesh (`data` x `model` axes): one process per rank in the
    port, rank = d * model_parallel + m (`parallel/mesh.py::build_mesh`);
    `Trainer(plan=)` trains over it."""

    data_axis: str = "data"
    model_axis: str = "model"
    #: -1 = infer from the available devices
    data_parallel: int = -1
    model_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Online-serving parameters; the JAX package's fields and defaults."""

    port: int = 6010
    candidate_size: int = 800                 # `RecForYouProcess.java:35-37`
    similar_genre_top: int = 100              # `SimilarMovieProcess.java:52`
    ab_traffic_split: int = 5                 # `ABTest.java:8`
    default_model: str = "emb"
    #: the reference spells it "nerualcf" in `ABTest.java:14`; both are taken
    neuralcf_aliases: Tuple[str, ...] = ("neuralcf", "nerualcf")
    #: static assets dir (the frontend pages)
    webroot: Optional[str] = None
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
    #: bfloat16 storage for the big leaves (at least
    #: `optim.SMALL_LEAF_MAX_ELEMS` elements: the embedding tables), with
    #: float32 master weights in the optimizer state. The Trainer raises
    #: on it together with `sparse_tables` (see `training/loop.py`).
    bf16_table_params: bool = False
    #: In the JAX package, routes the lazy row-Adam's row write through
    #: the Pallas row-DMA kernel. Kept for config parity; the port's
    #: row-Adam always moves its rows through the row kernels
    #: (`ops/rowio.py`) on the card, because the values are the same
    #: either way (`row_optim.py:178-186`).
    sparse_rowio: bool = False
    #: Storage dtype of the big leaves' Adam moments ("float32" or
    #: "bfloat16"); the update math stays float32.
    big_moment_dtype: str = "float32"
    shuffle_each_epoch: bool = True
    #: "exact" permutes rows; "blocks" permutes fixed blocks of
    #: `shuffle_block` rows of the zero-padded epoch (an approximate
    #: shuffle, as the reference's buffer shuffle is).
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


@dataclasses.dataclass(frozen=True)
class SparrowConfig:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    serving: ServingConfig = dataclasses.field(default_factory=ServingConfig)


_SECTIONS = {
    "data": DataConfig,
    "model": ModelConfig,
    "mesh": MeshConfig,
    "train": TrainConfig,
    "serving": ServingConfig,
}


def default_config() -> SparrowConfig:
    return SparrowConfig()


def config_to_json(config: SparrowConfig, path: str) -> None:
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(config), f, indent=1)


def config_from_json(path: str) -> SparrowConfig:
    """Load a config file. Unknown keys raise ValueError (a typo would
    otherwise fall back to a default silently); lists become tuples."""
    with open(path) as f:
        blob = json.load(f)

    def build(cls, data: dict):
        unknown = set(data) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown {cls.__name__} keys: {sorted(unknown)}")
        kwargs = {}
        for k, v in data.items():
            if isinstance(v, dict) and k in _SECTIONS:
                kwargs[k] = build(_SECTIONS[k], v)
            elif isinstance(v, list):
                kwargs[k] = tuple(v)
            else:
                kwargs[k] = v
        return cls(**kwargs)

    return build(SparrowConfig, blob)

"""The 27-column sample schema: a copy of the parts of
`sparrowrecsys_tpu/data/schema.py` the serving assembler and the training
data need."""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

#: Column order of trainingSamples/testSamples CSVs (testSamples.csv:1).
SAMPLE_COLUMNS: List[str] = [
    "movieId", "userId", "rating", "timestamp", "label",
    "releaseYear", "movieGenre1", "movieGenre2", "movieGenre3",
    "movieRatingCount", "movieAvgRating", "movieRatingStddev",
    "userRatedMovie1", "userRatedMovie2", "userRatedMovie3",
    "userRatedMovie4", "userRatedMovie5",
    "userRatingCount", "userAvgReleaseYear", "userReleaseYearStddev",
    "userAvgRating", "userRatingStddev",
    "userGenre1", "userGenre2", "userGenre3", "userGenre4", "userGenre5",
]

GENRE_COLUMNS = [
    "movieGenre1", "movieGenre2", "movieGenre3",
    "userGenre1", "userGenre2", "userGenre3", "userGenre4", "userGenre5",
]

HISTORY_COLUMNS = [
    "userRatedMovie1", "userRatedMovie2", "userRatedMovie3",
    "userRatedMovie4", "userRatedMovie5",
]

#: Numeric feature columns used by the models (`EmbeddingMLP.py:68-74`).
NUMERIC_COLUMNS = [
    "releaseYear", "movieRatingCount", "movieAvgRating", "movieRatingStddev",
    "userRatingCount", "userAvgRating", "userRatingStddev",
]

#: Extra numerics produced by the pipeline but unused by the reference zoo.
EXTRA_NUMERIC_COLUMNS = ["userAvgReleaseYear", "userReleaseYearStddev"]


@dataclasses.dataclass
class SampleTable:
    """Columnar sample table: dense numpy columns of one length. Genre
    columns hold vocab indices with -1 for missing/OOV, history columns
    0 for missing."""

    columns: Dict[str, np.ndarray]

    def __len__(self) -> int:
        return len(next(iter(self.columns.values())))

    def __getitem__(self, key: str) -> np.ndarray:
        return self.columns[key]

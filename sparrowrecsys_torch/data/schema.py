"""The 27-column sample schema: a copy of `sparrowrecsys_tpu/data/schema.py`.

The header of the reference's `testSamples.csv` is the contract between
the feature job (`data/feature_pipeline.py`) and the model zoo."""

from __future__ import annotations

import csv
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

_TWO_DECIMALS = ("movieAvgRating", "movieRatingStddev", "userAvgRating",
                 "userRatingStddev", "userReleaseYearStddev")


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

    def select(self, idx: np.ndarray) -> "SampleTable":
        return SampleTable({k: v[idx] for k, v in self.columns.items()})

    def to_csv(self, path: str, genre_vocab) -> None:
        """Write the reference CSV format: genre strings, '' for a missing
        history id or genre, two decimals for the averages and stddevs."""
        cols = self.columns
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(SAMPLE_COLUMNS)
            for i in range(len(self)):
                row = []
                for c in SAMPLE_COLUMNS:
                    v = cols[c][i]
                    if c in GENRE_COLUMNS:
                        row.append(genre_vocab[int(v)] if int(v) >= 0 else "")
                    elif c in HISTORY_COLUMNS:
                        row.append(str(int(v)) if int(v) > 0 else "")
                    elif c in _TWO_DECIMALS:
                        row.append(f"{float(v):.2f}")
                    elif c == "rating":
                        row.append(f"{float(v):g}")
                    else:
                        row.append(str(int(v)))
                w.writerow(row)

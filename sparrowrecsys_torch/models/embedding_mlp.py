"""Embedding MLP: the port of `sparrowrecsys_tpu/models/embedding_mlp.py`.

7 numerics, the 8 genre columns' embeddings (19-vocab) and the movie and
user id embeddings, concatenated -> Dense(hidden, relu) x 2 -> Dense(1):
logits [B]. Module names are the flax ones, so `params_from_flax` loads
an export.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from sparrowrecsys_torch.config import EMBEDDING_DIM, MOVIE_VOCAB_SIZE, USER_VOCAB_SIZE
from sparrowrecsys_torch.models.features import (
    GENRE_COLS,
    NUMERIC_COLS,
    GenreEmbed,
    IdEmbed,
    compute_dtype as dtype_of,
    dense,
    numeric_stack,
)


def deep_inputs(model: nn.Module, features: Dict[str, torch.Tensor]) -> torch.Tensor:
    """[numerics, 8 genre embeddings, movie emb, user emb] -> [B, 7 + 10 D]:
    the input EmbeddingMLP and Wide&Deep's deep part share."""
    parts = [numeric_stack(features)]
    parts += [getattr(model, f"emb_{c}")(features[c]) for c in GENRE_COLS]
    parts.append(model.emb_movieId(features["movieId"]))
    parts.append(model.emb_userId(features["userId"]))
    return torch.cat(parts, dim=-1)


def add_deep_embeddings(model: nn.Module, dim: int, movie_buckets: int,
                        user_buckets: int, lookup_dtype: Optional[str]) -> int:
    """Register the embeddings `deep_inputs` reads; returns its width."""
    for c in GENRE_COLS:
        setattr(model, f"emb_{c}", GenreEmbed(dim))
    model.emb_movieId = IdEmbed(movie_buckets, dim, lookup_dtype=lookup_dtype)
    model.emb_userId = IdEmbed(user_buckets, dim, lookup_dtype=lookup_dtype)
    return len(NUMERIC_COLS) + (len(GENRE_COLS) + 2) * dim


class EmbeddingMLP(nn.Module):
    def __init__(
        self,
        hidden: int = 128,
        compute_dtype: str = "float32",
        dim: int = EMBEDDING_DIM,
        movie_buckets: int = MOVIE_VOCAB_SIZE,
        user_buckets: int = USER_VOCAB_SIZE,
        lookup_dtype: Optional[str] = None,
    ):
        super().__init__()
        self.tower_dtype = dtype_of(compute_dtype)
        width = add_deep_embeddings(self, dim, movie_buckets, user_buckets, lookup_dtype)
        self.dense1 = nn.Linear(width, hidden)
        self.dense2 = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, 1)

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = deep_inputs(self, features)
        x = torch.relu(dense(self.dense1, x, self.tower_dtype))
        x = torch.relu(dense(self.dense2, x, self.tower_dtype))
        return self.out(x.float())[..., 0]

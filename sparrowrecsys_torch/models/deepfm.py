"""DeepFM v1 and v2: the port of `sparrowrecsys_tpu/models/deepfm.py`.

v1: first-order id biases, four pairwise dots of the movie, user and
first-genre embeddings, and a deep tower over numerics + movie + user.
v2: first-order biases + Dense(1) over numerics; five fields (four
embeddings and the numeric vector) each projected to `field_dim`, the
FM cross over them (`ops/fm.py::fm_cross`, a CUDA kernel on the card),
and a deep tower over the flattened fields.

Module names are the flax ones, so `params_from_flax` loads an export.
Both return logits [B].
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from sparrowrecsys_torch.config import EMBEDDING_DIM, MOVIE_VOCAB_SIZE, USER_VOCAB_SIZE
from sparrowrecsys_torch.models.features import (
    NUMERIC_COLS,
    GenreEmbed,
    IdBias,
    IdEmbed,
    compute_dtype as dtype_of,
    dense,
    merged_embed_bias,
    numeric_stack,
    project_fields,
)
from sparrowrecsys_torch.ops.fm import fm_cross


class _FMBase(nn.Module):
    """The four merged id/genre embedding + bias columns both versions share."""

    def __init__(self, dim, movie_buckets, user_buckets, lookup_dtype):
        super().__init__()
        self.emb_movieId = IdEmbed(movie_buckets, dim, lookup_dtype=lookup_dtype)
        self.bias_movieId = IdBias(movie_buckets)
        self.emb_userId = IdEmbed(user_buckets, dim, lookup_dtype=lookup_dtype)
        self.bias_userId = IdBias(user_buckets)
        self.emb_movieGenre1 = GenreEmbed(dim)
        self.bias_movieGenre1 = IdBias(19)
        self.emb_userGenre1 = GenreEmbed(dim)
        self.bias_userGenre1 = IdBias(19)

    def lookups(self, features: Dict[str, torch.Tensor]):
        """(item, user, item_genre, user_genre) embeddings and the summed
        first-order id bias [B]."""
        item, b_item = merged_embed_bias(
            self.emb_movieId(), self.bias_movieId(), features["movieId"])
        user, b_user = merged_embed_bias(
            self.emb_userId(), self.bias_userId(), features["userId"])
        item_genre, b_mg = merged_embed_bias(
            self.emb_movieGenre1(), self.bias_movieGenre1(), features["movieGenre1"])
        user_genre, b_ug = merged_embed_bias(
            self.emb_userGenre1(), self.bias_userGenre1(), features["userGenre1"])
        first = b_item + b_user + b_ug + b_mg
        return item, user, item_genre, user_genre, first


class DeepFM(_FMBase):
    """DeepFM v1: pairwise-dot FM."""

    def __init__(
        self,
        deep_hidden: int = 64,
        compute_dtype: str = "float32",
        dim: int = EMBEDDING_DIM,
        movie_buckets: int = MOVIE_VOCAB_SIZE,
        user_buckets: int = USER_VOCAB_SIZE,
        lookup_dtype: Optional[str] = None,
    ):
        super().__init__(dim, movie_buckets, user_buckets, lookup_dtype)
        self.tower_dtype = dtype_of(compute_dtype)
        self.deep1 = nn.Linear(len(NUMERIC_COLS) + 2 * dim, deep_hidden)
        self.deep2 = nn.Linear(deep_hidden, deep_hidden)
        self.out = nn.Linear(4 + deep_hidden, 1)

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        item, user, item_genre, user_genre, first = self.lookups(features)
        dots = torch.stack(
            [
                (item * user).sum(-1),
                (item_genre * user_genre).sum(-1),
                (item_genre * user).sum(-1),
                (item * user_genre).sum(-1),
            ],
            dim=-1,
        )
        deep = torch.cat([numeric_stack(features), item, user], dim=-1)
        deep = torch.relu(dense(self.deep1, deep, self.tower_dtype))
        deep = torch.relu(dense(self.deep2, deep, self.tower_dtype)).float()
        x = torch.cat([dots, deep], dim=-1)
        return self.out(x)[..., 0] + first


class DeepFMv2(_FMBase):
    """DeepFM v2: the full FM cross over five projected fields."""

    _FIELDS = ("proj_itemGenre", "proj_item", "proj_userGenre", "proj_user",
               "proj_numeric")

    def __init__(
        self,
        field_dim: int = 64,
        compute_dtype: str = "float32",
        dim: int = EMBEDDING_DIM,
        movie_buckets: int = MOVIE_VOCAB_SIZE,
        user_buckets: int = USER_VOCAB_SIZE,
        lookup_dtype: Optional[str] = None,
        deep_hidden: int = 32,
    ):
        super().__init__(dim, movie_buckets, user_buckets, lookup_dtype)
        self.tower_dtype = dtype_of(compute_dtype)
        n_num = len(NUMERIC_COLS)
        self.first_deep = nn.Linear(n_num, 1)
        for name, width in zip(self._FIELDS, (dim, dim, dim, dim, n_num)):
            setattr(self, name, nn.Linear(width, field_dim))
        self.deep1 = nn.Linear(len(self._FIELDS) * field_dim, deep_hidden)
        self.deep2 = nn.Linear(deep_hidden, deep_hidden // 2)
        self.out = nn.Linear(1 + field_dim + deep_hidden // 2, 1)

    def fields(self, features: Dict[str, torch.Tensor]):
        """(first-order term [B], projected fields [B, 5, field_dim])."""
        item, user, item_genre, user_genre, first = self.lookups(features)
        numerics = numeric_stack(features)
        first = first + self.first_deep(numerics)[..., 0]
        fields = project_fields(
            [item_genre, item, user_genre, user, numerics],
            [getattr(self, n) for n in self._FIELDS],
        )
        return first, fields

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        first, fields = self.fields(features)
        fm = fm_cross(fields)
        deep = fields.reshape(fields.shape[0], -1)
        deep = torch.relu(dense(self.deep1, deep, self.tower_dtype))
        deep = torch.relu(dense(self.deep2, deep, self.tower_dtype)).float()
        x = torch.cat([first[:, None], fm, deep], dim=-1)
        return self.out(x)[..., 0]

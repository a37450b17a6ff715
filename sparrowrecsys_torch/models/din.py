"""DIN (Deep Interest Network): the port of `sparrowrecsys_tpu/models/din.py`.

- one shared movie table with `mask_zero`: the candidate movieId rides the
  history gather as column 0 of one [B, T+1] lookup (din.py:72-81);
- the activation unit pools the history against the candidate
  (`ops/attention.py::din_attention`, a CUDA kernel on the card);
- user profile [user emb, userGenre1 emb, 3 user numerics] and context
  [movieGenre1 emb, 4 movie numerics];
- concat(profile, pooled, candidate, context) -> Dense(hidden) -> PReLU
  -> Dense(hidden // 2) -> PReLU -> Dense(1): logits [B].

Parameter names are the flax ones, so `params_from_flax` loads an export.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from sparrowrecsys_torch.config import EMBEDDING_DIM, MOVIE_VOCAB_SIZE, USER_VOCAB_SIZE
from sparrowrecsys_torch.models.features import (
    GenreEmbed,
    IdEmbed,
    PReLU,
    compute_dtype as dtype_of,
    dense,
    history_stack,
    numeric_stack,
)
from sparrowrecsys_torch.ops.attention import din_attention

USER_NUMERICS = ("userRatingCount", "userAvgRating", "userRatingStddev")
MOVIE_NUMERICS = ("releaseYear", "movieRatingCount", "movieAvgRating",
                  "movieRatingStddev")


def _lecun_normal(fan_in: int, fan_out: int) -> nn.Parameter:
    return nn.Parameter(torch.randn(fan_in, fan_out) / math.sqrt(fan_in))


class DIN(nn.Module):
    def __init__(
        self,
        dim: int = EMBEDDING_DIM,
        movie_buckets: int = MOVIE_VOCAB_SIZE,
        user_buckets: int = USER_VOCAB_SIZE,
        attention_hidden: int = 32,
        compute_dtype: str = "float32",
        lookup_dtype: Optional[str] = None,
        recent_movies: int = 5,
        hidden: int = 128,
    ):
        super().__init__()
        self.recent_movies = recent_movies
        self.tower_dtype = dtype_of(compute_dtype)
        self.emb_movie_shared = IdEmbed(
            movie_buckets, dim, mask_zero=True, lookup_dtype=lookup_dtype)
        self.att_w1 = _lecun_normal(4 * dim, attention_hidden)
        self.att_b1 = nn.Parameter(torch.zeros(attention_hidden))
        self.att_prelu = nn.Parameter(torch.zeros(attention_hidden))
        self.att_w2 = _lecun_normal(attention_hidden, 1)
        self.att_b2 = nn.Parameter(torch.zeros(1))
        self.emb_userId = IdEmbed(user_buckets, dim, lookup_dtype=lookup_dtype)
        self.emb_userGenre1 = GenreEmbed(dim)
        self.emb_movieGenre1 = GenreEmbed(dim)
        width = (2 * dim + len(USER_NUMERICS)) + dim + dim + (dim + len(MOVIE_NUMERICS))
        self.fc1 = nn.Linear(width, hidden)
        self.prelu1 = PReLU(hidden)
        self.fc2 = nn.Linear(hidden, hidden // 2)
        self.prelu2 = PReLU(hidden // 2)
        self.out = nn.Linear(hidden // 2, 1)

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        ids = torch.cat(
            [features["movieId"][:, None],
             history_stack(features, self.recent_movies)],
            dim=1,
        )
        ch = self.emb_movie_shared(ids)                          # [B, T+1, D]
        # The kernel takes contiguous tensors; the slices are views.
        cand, hist = ch[:, 0].contiguous(), ch[:, 1:].contiguous()
        pooled = din_attention(
            hist, cand, self.att_w1, self.att_b1, self.att_prelu,
            self.att_w2, self.att_b2,
        )                                                        # [B, D]
        profile = torch.cat(
            [self.emb_userId(features["userId"]),
             self.emb_userGenre1(features["userGenre1"]),
             numeric_stack(features, USER_NUMERICS)],
            dim=-1,
        )
        context = torch.cat(
            [self.emb_movieGenre1(features["movieGenre1"]),
             numeric_stack(features, MOVIE_NUMERICS)],
            dim=-1,
        )
        x = torch.cat([profile, pooled, cand, context], dim=-1)
        x = self.prelu1(dense(self.fc1, x, self.tower_dtype).float())
        x = self.prelu2(dense(self.fc2, x, self.tower_dtype).float())
        return self.out(x)[..., 0]

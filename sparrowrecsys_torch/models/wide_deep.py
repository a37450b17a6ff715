"""Wide&Deep: the port of `sparrowrecsys_tpu/models/wide_deep.py`.

deep: the EmbeddingMLP input (7 numerics, 8 genre embeddings, movie and
user id embeddings) -> Dense(hidden, relu) x 2; wide: one weight per
bucket of the crossed (movieId, userRatedMovie1) column (`cross_hash`),
gathered as an `IdBias` in place of a [B, 10000] one-hot; logit =
Dense(1)(deep) + wide. Module names are the flax ones.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from sparrowrecsys_torch.config import EMBEDDING_DIM, MOVIE_VOCAB_SIZE, USER_VOCAB_SIZE
from sparrowrecsys_torch.models.embedding_mlp import add_deep_embeddings, deep_inputs
from sparrowrecsys_torch.models.features import IdBias, compute_dtype as dtype_of, dense

_U32 = 0xFFFFFFFF


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32): the constant is split in
    16-bit halves so that no int64 product overflows (x * 2^16 < 2^48)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def cross_hash(a: torch.Tensor, b: torch.Tensor, buckets: int) -> torch.Tensor:
    """The JAX package's uint32 multiply-xor-shift hash of an id pair into
    [0, buckets), bit for bit (`wide_deep.py:35`). torch's uint32 lacks
    most operations, so the arithmetic runs in int64 on the low 32 bits;
    a negative id is taken mod 2^32, as `astype(jnp.uint32)` takes it."""
    x = _mul_u32(a.to(torch.int64) & _U32, 2654435761) ^ (b.to(torch.int64) & _U32)
    x = _mul_u32(x, 2246822519)
    x = x ^ (x >> 13)
    x = _mul_u32(x, 3266489917)
    x = x ^ (x >> 16)
    return (x % buckets).to(torch.int32)


class WideNDeep(nn.Module):
    def __init__(
        self,
        hidden: int = 128,
        compute_dtype: str = "float32",
        lookup_dtype: Optional[str] = None,
        dim: int = EMBEDDING_DIM,
        movie_buckets: int = MOVIE_VOCAB_SIZE,
        user_buckets: int = USER_VOCAB_SIZE,
        cross_buckets: int = 10000,
    ):
        super().__init__()
        self.tower_dtype = dtype_of(compute_dtype)
        self.cross_buckets = cross_buckets
        width = add_deep_embeddings(self, dim, movie_buckets, user_buckets, lookup_dtype)
        self.deep1 = nn.Linear(width, hidden)
        self.deep2 = nn.Linear(hidden, hidden)
        self.wide_cross = IdBias(cross_buckets)
        self.out = nn.Linear(hidden, 1)

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        deep = deep_inputs(self, features)
        deep = torch.relu(dense(self.deep1, deep, self.tower_dtype))
        deep = torch.relu(dense(self.deep2, deep, self.tower_dtype)).float()
        crossed = cross_hash(features["movieId"], features["userRatedMovie1"],
                             self.cross_buckets)
        return self.out(deep)[..., 0] + self.wide_cross(crossed)

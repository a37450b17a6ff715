"""Shared feature-encoding blocks for the model zoo.

The port of `sparrowrecsys_tpu/models/features.py`. Features arrive
pre-encoded (`serving/assembler.py`): int32 genre vocab indices with -1
for OOV, int32 ids with 0 as the history pad, float32 numerics.

Parameter names are the flax ones (`table`, `w`, `alpha`, and Dense
`kernel`/`bias` as `nn.Linear` `weight`/`bias`), so an exported flax
tree loads through `training.checkpoint.params_from_flax`. Initial
values follow the JAX package's initialisers in kind; tests and serving
load real weights.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sparrowrecsys_torch.config import EMBEDDING_DIM, GENRE_VOCAB
from sparrowrecsys_torch.ops.embedding import embed_lookup

NUMERIC_COLS = (
    "releaseYear", "movieRatingCount", "movieAvgRating", "movieRatingStddev",
    "userRatingCount", "userAvgRating", "userRatingStddev",
)


def compute_dtype(name: str) -> torch.dtype:
    """ModelConfig.compute_dtype -> torch dtype (params stay float32)."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _uniform_table(rows: int, dim: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(rows, dim).uniform_(-0.05, 0.05))


class GenreEmbed(nn.Module):
    """Per-column 19-vocab embedding; OOV (-1) gives zeros. `idx=None`
    returns the raw [vocab, dim] table (for `merged_embed_bias`)."""

    def __init__(self, dim: int = EMBEDDING_DIM, vocab: int = len(GENRE_VOCAB)):
        super().__init__()
        self.table = _uniform_table(vocab, dim)

    def forward(self, idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        if idx is None:
            return self.table
        return embed_lookup(self.table, idx)


class IdEmbed(nn.Module):
    """Identity-bucket id embedding. `lookup_dtype` (e.g. "bfloat16")
    casts the table before the gather, as `IdEmbed.lookup_dtype` does in
    the JAX package (:90-101); params stay float32."""

    def __init__(
        self,
        buckets: int,
        dim: int = EMBEDDING_DIM,
        mask_zero: bool = False,
        lookup_dtype: Optional[str] = None,
    ):
        super().__init__()
        self.mask_zero = mask_zero
        self.lookup_dtype = lookup_dtype
        self.table = _uniform_table(buckets, dim)

    def forward(self, idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        table = self.table
        if self.lookup_dtype is not None:
            table = table.to(compute_dtype(self.lookup_dtype))
        if idx is None:
            return table
        return embed_lookup(table, idx, mask_zero=self.mask_zero)


class IdBias(nn.Module):
    """First-order weight of a one-hot indicator column as a [V, 1] gather
    (`w` starts at zero). `idx=None` returns the raw column."""

    def __init__(self, buckets: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(buckets, 1))

    def forward(self, idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        if idx is None:
            return self.w
        return embed_lookup(self.w, idx)[..., 0]


def merged_embed_bias(
    emb_table: torch.Tensor, bias_col: torch.Tensor, idx: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """One gather for an id column's embedding [B, D] and its bias [B]."""
    merged = torch.cat([emb_table, bias_col.to(emb_table.dtype)], dim=1)
    out = embed_lookup(merged, idx)
    return out[..., :-1], out[..., -1]


def numeric_stack(
    features: Dict[str, torch.Tensor], cols: Sequence[str] = NUMERIC_COLS
) -> torch.Tensor:
    """Stack numeric columns -> [B, len(cols)] float32."""
    return torch.stack([features[c].float() for c in cols], dim=-1)


def history_stack(features: Dict[str, torch.Tensor], length: int = 5) -> torch.Tensor:
    """Stack userRatedMovie1..length -> [B, T] ids (0 = pad)."""
    return torch.stack(
        [features[f"userRatedMovie{k + 1}"] for k in range(length)], dim=-1
    )


class PReLU(nn.Module):
    """Keras PReLU: learnable per-channel negative slope, starting at 0.
    Flax infers the width from the input; here it is given."""

    def __init__(self, features: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha * x)


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """flax `nn.Dense(dtype=...)`: input, kernel and bias cast to `dtype`;
    the product is rounded to `dtype` before the bias is added, as flax
    rounds it (one fused addmm would round once)."""
    if dtype == torch.float32 and x.dtype == torch.float32:
        return layer(x)
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)


def project_fields(xs: Sequence[torch.Tensor], layers: Sequence[nn.Linear]) -> torch.Tensor:
    """Per-field projections stacked to [B, F, N].

    The port of `folded_dense`/`folded_projections` (:228-251). The JAX
    package folds the projections into one block-diagonal matmul to fill
    the TPU's 128-lane matrix unit; the zero blocks add exact zeros, so
    applying each layer on its own gives the same numbers. Each
    `LinParams` of the JAX model is an `nn.Linear` here."""
    return torch.stack([dense(layer, x) for x, layer in zip(xs, layers)], dim=1)

"""Shared feature-encoding blocks for the model zoo.

The port of `sparrowrecsys_tpu/models/features.py`. Features arrive
pre-encoded (`serving/assembler.py`): int32 genre vocab indices with -1
for OOV, int32 ids with 0 as the history pad, float32 numerics.

Parameter names are the flax ones (`table`, `w`, `alpha`, and Dense
`kernel`/`bias` as `nn.Linear` `weight`/`bias`), so an exported flax
tree loads through `training.checkpoint.params_from_flax`. A module's
own initial values are PyTorch's; `flax_init` draws a parameter dict from
the distributions the JAX package's initialisers use, which is what the
Trainer trains from.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sparrowrecsys_torch.config import EMBEDDING_DIM, GENRE_VOCAB
from sparrowrecsys_torch.ops.embedding import (
    cast_rows,
    embed_lookup,
    packed_multi_lookup,
    row_shard_of,
    uniform_embed_init,
)

GENRE_COLS = (
    "userGenre1", "userGenre2", "userGenre3", "userGenre4", "userGenre5",
    "movieGenre1", "movieGenre2", "movieGenre3",
)

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
            table = cast_rows(table, compute_dtype(self.lookup_dtype))
        if idx is None:
            return table
        return embed_lookup(table, idx, mask_zero=self.mask_zero)


class IdBias(nn.Module):
    """First-order weight of a one-hot indicator column as a [V, 1] gather
    (`w` starts at zero), over an id column or a computed index such as
    Wide&Deep's crossed bucket. `idx=None` returns the raw column."""

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
    """One gather for an id column's embedding [B, D] and its bias [B]; a
    gather each when either is a row block of a sharded table
    (`ops/embedding.py::row_sharded`), with the same values."""
    if row_shard_of(emb_table) is not None or row_shard_of(bias_col) is not None:
        bias = cast_rows(bias_col, emb_table.dtype)
        return embed_lookup(emb_table, idx), embed_lookup(bias, idx)[..., 0]
    merged = torch.cat([emb_table, bias_col.to(emb_table.dtype)], dim=1)
    out = embed_lookup(merged, idx)
    return out[..., :-1], out[..., -1]


def packed_embed_bias(columns):
    """`merged_embed_bias` for several id columns riding one gather
    (`models/features.py::packed_embed_bias`, :148-170).

    columns: (emb_table [V, D], bias_col [V, 1], idx [B]) each. Each
    table is merged with its bias column into [V, D+1], and all of them
    go through one `packed_multi_lookup`. Returns a list of
    (embedding [B, D], bias [B]) pairs, equal to `merged_embed_bias`'s
    (and made by it when a table is a row block of a sharded one)."""
    if any(row_shard_of(t) is not None for col in columns for t in col[:2]):
        return [merged_embed_bias(emb, bias, idx) for emb, bias, idx in columns]
    merged = [torch.cat([emb, bias.to(emb.dtype)], dim=1) for emb, bias, _ in columns]
    outs = packed_multi_lookup(merged, [idx for _, _, idx in columns])
    return [(o[..., :-1], o[..., -1]) for o in outs]


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


#: flax's `lecun_normal`: a normal truncated to two standard deviations,
#: scaled by this so the truncated draw has variance 1/fan_in.
_TRUNC_STD = 0.87962566103423978


def lecun_normal(shape, fan_in: int, generator: torch.Generator, device=None) -> torch.Tensor:
    """flax `nn.initializers.lecun_normal()`: truncated normal in
    [-2, 2] standard units, stddev sqrt(1 / fan_in) / 0.8796."""
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)).to(device)


def flax_init(model: nn.Module, generator: torch.Generator,
              device=None) -> Dict[str, torch.Tensor]:
    """A fresh parameter dict (state_dict names) with the distributions of
    the JAX package's initialisers: embedding tables uniform(-0.05, 0.05);
    Dense kernels (an `nn.Linear` weight, or a raw [in, out] kernel the
    model lists in `RAW_KERNELS`, such as DIN's `att_w1`) lecun-normal
    over their fan-in; the raw kernels a model lists in
    `ORTHOGONAL_KERNELS` (DIEN's `gru_recurrent`) orthogonal, as flax's
    `orthogonal()` draws them; biases, PReLU slopes
    and first-order id weights zeros, as flax's `Dense`, `PReLU` and
    `IdBias` have them."""
    linear = {name for name, m in model.named_modules() if isinstance(m, nn.Linear)}
    table = uniform_embed_init()
    out: Dict[str, torch.Tensor] = {}
    for name, p in model.named_parameters():
        mod, _, leaf = name.rpartition(".")
        if mod in linear and leaf == "weight":
            out[name] = lecun_normal(p.shape, p.shape[1], generator, device)
        elif leaf == "table":
            out[name] = table(p.shape, generator, device)
        elif name in getattr(model, "RAW_KERNELS", ()):
            out[name] = lecun_normal(p.shape, p.shape[0], generator, device)
        elif name in getattr(model, "ORTHOGONAL_KERNELS", ()):
            t = torch.empty(p.shape, dtype=torch.float32)
            out[name] = torch.nn.init.orthogonal_(t, generator=generator).to(device)
        else:
            out[name] = torch.zeros(p.shape, dtype=torch.float32, device=device)
    return out

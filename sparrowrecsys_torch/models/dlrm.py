"""DLRM with a DCN-v2 interaction (DLRM-DCNv2): the model of the MLPerf
Training recommendation benchmark (MLCommons `recommendation_v2/
torchrec_dlrm`, TorchRec's `DLRM_DCN`, trained on Criteo 1TB multi-hot).

- dense arch: the 13 dense features [B, 13] through Linear + ReLU layers
  of `dense_sizes` (13 -> 512 -> 256 -> 128), ReLU after every layer;
- sparse arch: 26 tables [rows_f, D]; feature f (`cat_f`, int ids
  [B, k_f]) is the sum of its k_f rows (`ops/embedding.py::embed_lookup`,
  an id outside [0, rows_f) a zero row), [B, 26, D] in all;
- interaction: x0 = [d, e_0, ..., e_25] flattened, [B, 27 D]; then
  `cross_layers` low-rank cross layers x_{l+1} = x0 * (W_l (V_l x_l) +
  b_l) + x_l, with V_l: 27 D -> `cross_rank` and W_l: `cross_rank` ->
  27 D (bias b_l), stored as [in, out] kernels `cross.l.v`, `cross.l.w`;
- over arch: Linear + ReLU layers of `over_sizes` but the last, then
  Linear(.., 1): logits [B].

The defaults are the published settings. Each table is a module holding
`.table`, so `Trainer(sparse_tables=)` can take it; `sparse_tables()`
names the tables whose gradient the small-table backward
(`embedding_bwd`) cannot hold. The default tables hold 204 M rows: build
such a model on the meta device (`with torch.device("meta")`), where its
parameters are shapes alone; the trainer leaves it there and every step
passes its own parameters.

`compute_dtype="bfloat16"` runs the three MLP stacks and the cross layers
on bfloat16 inputs and weights (the lookups and the logits stay float32).
The JAX package has no such model: the tests hold it against the plain
reference `reference/dlrm_dcnv2.py`.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
from torch import nn

from sparrowrecsys_torch.models.features import compute_dtype as dtype_of, dense
from sparrowrecsys_torch.ops.embedding import bwd_fits, embed_lookup
from sparrowrecsys_torch.utils.profiling import backward_span, span

#: `num_embeddings_per_feature` of the MLPerf reference (the five largest
#: capped at 40,000,000 rows).
TABLE_ROWS = (40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 40000000, 3067956,
              405282, 10, 2209, 11938, 155, 4, 976, 14, 40000000, 40000000, 40000000, 590152,
              12973, 108, 36)
#: `multi_hot_sizes`: the ids of each feature in an example (214 in all).
MULTI_HOT = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100, 27, 10, 3, 1, 1)
DENSE_FEATURES = 13


class Table(nn.Module):
    """One embedding table, TorchRec's initialisation: uniform(-a, a) with
    a = sqrt(1 / rows)."""

    def __init__(self, rows: int, dim: int):
        super().__init__()
        a = math.sqrt(1.0 / rows)
        self.table = nn.Parameter(torch.empty(rows, dim).uniform_(-a, a))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """Integer ids [B, k] -> the sum of their rows, [B, D]."""
        return embed_lookup(self.table, ids).sum(dim=1)


class LowRankCross(nn.Module):
    """One cross layer's V [in, rank], W [rank, in] and bias [in],
    TorchRec's `LowRankCrossNet` initialisation (Xavier-normal kernels,
    zero bias)."""

    def __init__(self, width: int, rank: int):
        super().__init__()
        self.v = nn.Parameter(nn.init.xavier_normal_(torch.empty(width, rank)))
        self.w = nn.Parameter(nn.init.xavier_normal_(torch.empty(rank, width)))
        self.b = nn.Parameter(torch.zeros(width))


def low_rank_cross(x0: torch.Tensor, *weights: torch.Tensor) -> torch.Tensor:
    """x_{l+1} = x0 * (x_l @ V_l @ W_l + b_l) + x_l from x_0 = x0, for each
    (V_l, W_l, b_l) in `weights`; computes in x0's dtype."""
    x = x0
    for i in range(0, len(weights), 3):
        v, w, b = (t.to(x0.dtype) for t in weights[i:i + 3])
        x = x0 * torch.addmm(b, x @ v, w) + x
    return x


def _mlp(layers: Sequence[nn.Linear], x: torch.Tensor, dtype: torch.dtype,
         relu_last: bool) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = dense(layer, x, dtype)
        if relu_last or i < len(layers) - 1:
            x = torch.relu(x)
    return x.float()


class DLRMDCNv2(nn.Module):
    def __init__(
        self,
        embedding_dim: int = 128,
        dense_sizes: Sequence[int] = (512, 256, 128),
        over_sizes: Sequence[int] = (1024, 1024, 512, 256, 1),
        cross_layers: int = 3,
        cross_rank: int = 512,
        table_rows: Sequence[int] = TABLE_ROWS,
        multi_hot: Sequence[int] = MULTI_HOT,
        compute_dtype: str = "float32",
    ):
        super().__init__()
        if len(table_rows) != len(multi_hot):
            raise ValueError(f"{len(table_rows)} tables for {len(multi_hot)} multi-hot sizes")
        if dense_sizes[-1] != embedding_dim or over_sizes[-1] != 1:
            raise ValueError("the dense arch ends at the embedding's width and the over arch "
                             f"at one logit; got {tuple(dense_sizes)}, {tuple(over_sizes)}")
        self.embedding_dim = embedding_dim
        self.table_rows, self.multi_hot = tuple(table_rows), tuple(multi_hot)
        self.dtype = dtype_of(compute_dtype)
        widths = (DENSE_FEATURES, *dense_sizes)
        self.bottom = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths, widths[1:]))
        for f, rows in enumerate(self.table_rows):
            self.add_module(f"emb_cat_{f}", Table(rows, embedding_dim))
        width = (len(self.table_rows) + 1) * embedding_dim
        self.cross = nn.ModuleList(LowRankCross(width, cross_rank) for _ in range(cross_layers))
        widths = (width, *over_sizes)
        self.top = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths, widths[1:]))
        #: [in, out] kernels that are raw parameters (`flax_init`).
        self.RAW_KERNELS = tuple(f"cross.{i}.{k}" for i in range(cross_layers) for k in "vw")

    def tables(self):
        return [getattr(self, f"emb_cat_{f}") for f in range(len(self.table_rows))]

    def sparse_tables(self) -> Dict[str, tuple]:
        """{table module: (its column,)} for every table outside `bwd_fits`:
        the `Trainer(sparse_tables=)` of a DLRM trainer, whose other tables
        take the small-table backward and the dense Adam."""
        return {f"emb_cat_{f}": (f"cat_{f}",) for f, rows in enumerate(self.table_rows)
                if not bwd_fits(rows, self.embedding_dim)}

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        with span("dlrm.bottom"):
            d = _mlp(self.bottom, features["dense"].float(), self.dtype, relu_last=True)
        with span("dlrm.lookups"):
            pooled = [t(features[f"cat_{f}"]) for f, t in enumerate(self.tables())]
        x0 = torch.stack([d, *pooled], dim=1).flatten(1)             # [B, 27 D]
        with span("dlrm.cross"):
            weights = [p for layer in self.cross for p in (layer.v, layer.w, layer.b)]
            x = backward_span("dlrm.cross.backward", low_rank_cross, x0.to(self.dtype),
                              *weights).float()
        with span("dlrm.top"):
            return _mlp(self.top, x, self.dtype, relu_last=False)[..., 0]

"""Cosine scoring and top-k retrieval: the port of `sparrowrecsys_tpu/ops/topk.py`.

One matmul over the whole catalog, then a top-k in `jax.lax.top_k`'s
order: best score first, equal scores in ascending index order
(`top_k`). `torch.topk` alone gives tied scores in no fixed order (zero
rows and duplicate rows tie), so the port orders its result by a key that
breaks every tie by the index, and ranks again the rows whose k-th score
is also held by an entry outside the result. The JAX package leaves all
of this to XLA, so there is no kernel here.

Off the TPU the JAX package's measured policies answer "exact" and
"keep the dtype" (`topk_dispatch`, `prepare_catalog`); so do the port's.
`sharded_cosine_topk` runs the top-k over a catalog row-sharded across a
mesh's model ranks.
"""

from __future__ import annotations

from typing import Tuple

import torch

#: Catalog size from which the JAX package's `cosine_topk_auto` takes
#: `lax.approx_max_k`, on a TPU backend only; kept for callers that name it.
APPROX_TOPK_MIN_ITEMS = 100_000


def _order_key(scores: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 that orders as XLA's total order on floats does
    (-0.0 below +0.0): the sign-magnitude bits turned into two's complement."""
    bits = scores.contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def _by_key(values: torch.Tensor, index: torch.Tensor, m: int) -> torch.Tensor:
    """int64 keys (score bits << 32) | (m - 1 - index): unique per row, larger
    for a better score and, among equal scores, for a lower index."""
    return (_order_key(values).to(torch.int64) << 32) | (m - 1 - index)


def top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` over the last axis of float32 [Q, M] scores: ([Q, k]
    scores, [Q, k] int64 indices), best first, ties lowest index first.

    `torch.topk` for k + 1 picks the right set of k wherever its last
    score is below its k-th (no score outside the set equals the k-th);
    then only the order inside the set is repaired, on [Q, k]. The rows
    where the two are equal are ranked again by the unique key of
    `_by_key` over all M."""
    m = scores.shape[-1]
    vals, idx = torch.topk(scores, min(k + 1, m), dim=-1)
    if m > k:
        tied = vals[..., k] >= vals[..., k - 1]
        vals, idx = vals[..., :k].contiguous(), idx[..., :k].contiguous()
        if bool(tied.any()):
            rows = tied.nonzero()[:, 0]
            pos = torch.arange(m, device=scores.device)
            key = torch.topk(_by_key(scores[rows], pos, m), k, dim=-1).values
            idx[rows] = (m - 1) - (key & 0xFFFFFFFF)
            vals[rows] = scores[rows].gather(-1, idx[rows])
    order = torch.argsort(_by_key(vals, idx, m), dim=-1, descending=True)
    return vals.gather(-1, order), idx.gather(-1, order)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def cosine_scores(queries: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """[Q, D] x [M, D] -> cosine [Q, M]; zero vectors score 0."""
    return _normalize(queries) @ _normalize(items).T


def cosine_topk(
    queries: torch.Tensor, items: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact cosine top-k: ([Q, k] scores, [Q, k] indices), in `lax.top_k`'s order."""
    return top_k(cosine_scores(queries, items), k)


def cosine_topk_approx(
    queries: torch.Tensor, items: torch.Tensor, k: int, recall_target: float = 0.99
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact top-k: what `lax.approx_max_k` computes off the TPU.
    `recall_target` is accepted for the JAX signature."""
    return cosine_topk(queries, items, k)


def topk_dispatch(n_items: int) -> str:
    """The kernel `cosine_topk_auto` runs: "exact" at every size (the JAX
    package picks `approx_max_k` on a TPU backend only)."""
    return "exact"


def cosine_topk_auto(
    queries: torch.Tensor, items: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    return cosine_topk(queries, items, k)


class PreparedCatalog:
    """An item matrix that went through `prepare_catalog` (rows normalized,
    maybe stored narrow). `cosine_topk_prepared` takes only this wrapper,
    so a raw matrix cannot reach the path that skips the normalization."""

    __slots__ = ("rows",)

    def __init__(self, rows: torch.Tensor):
        self.rows = rows

    @property
    def shape(self):
        return self.rows.shape

    @property
    def dtype(self):
        return self.rows.dtype


def prepare_catalog(items: torch.Tensor, dtype=None) -> PreparedCatalog:
    """Normalize the rows once for repeated queries; stored in `dtype`
    (default: the items' dtype; e.g. torch.bfloat16 halves the bytes a
    query wave reads). float32 preparation scores as the unprepared path."""
    return PreparedCatalog(_normalize(items).to(items.dtype if dtype is None else dtype))


def _scores_f32(qn: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """qn (in rows' dtype) x rows^T with float32 products and sums."""
    if rows.dtype == torch.float32:
        return qn @ rows.T
    if rows.device.type == "cuda":
        return torch.mm(qn, rows.T, out_dtype=torch.float32)
    return qn.float() @ rows.float().T


def cosine_topk_prepared(
    queries: torch.Tensor, prepared: PreparedCatalog, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k against a `prepare_catalog` output; scores are float32."""
    if not isinstance(prepared, PreparedCatalog):
        raise TypeError(
            "cosine_topk_prepared needs a prepare_catalog() output "
            "(PreparedCatalog); got a raw tensor: its rows may not be "
            "normalized, which would silently corrupt the ranking."
        )
    qn = _normalize(queries).to(prepared.dtype)
    return top_k(_scores_f32(qn, prepared.rows), k)


def sharded_cosine_topk(
    queries: torch.Tensor,
    items,
    k: int,
    plan,
    *,
    approx: "bool | None" = None,
    prepared: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a catalog row-sharded across `plan`'s model ranks: the
    port of `ops/topk.py::sharded_cosine_topk` (:182-248).

    `items` is the whole catalog [M, D] (or its `prepare_catalog`
    output), padded with zero rows to whole blocks of ceil(M / n_model);
    this rank scores its block, takes its top-k, and the [Q, k] partials
    are all-gathered over `model` in shard order and merged by `top_k`.
    Equal scores come out by ascending global index, as from `lax.top_k`
    over the whole catalog: each shard's partial lists its ties that way,
    and the shards' partials sit in row order. Queries are the same on
    every rank; so is the result.

    A `PreparedCatalog` implies prepared=True; prepared=True with a raw
    tensor is a TypeError. `approx` is accepted for the JAX signature:
    off the TPU the per-shard stage is exact either way."""
    if isinstance(items, PreparedCatalog):
        items, prepared = items.rows, True
    elif prepared:
        raise TypeError(
            "sharded_cosine_topk(prepared=True) needs a prepare_catalog() "
            "output (PreparedCatalog), not a raw tensor.")
    m = items.shape[0]
    block = -(-m // plan.n_model)
    if block * plan.n_model != m:
        items = torch.cat([items, items.new_zeros(block * plan.n_model - m, items.shape[1])])
    lo = plan.model_index * block
    rows = items[lo:lo + block]
    if prepared:
        s, i = cosine_topk_prepared(queries, PreparedCatalog(rows), k)
    else:
        s, i = cosine_topk(queries, rows, k)
    i = i + lo
    # [Q, P*k]: the partials side by side in shard order.
    s_all = plan.all_gather(s.T.contiguous(), plan.model_axis).T
    i_all = plan.all_gather(i.T.contiguous(), plan.model_axis).T
    s_top, pos = top_k(s_all.contiguous(), k)
    return s_top, i_all.gather(1, pos)

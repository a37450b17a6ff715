"""Exact cosine scoring and top-k: the port of `sparrowrecsys_tpu/ops/topk.py`
(:27-45). One matmul plus `torch.topk`; the JAX package leaves this to
XLA too, so there is no kernel here."""

from __future__ import annotations

from typing import Tuple

import torch


def cosine_scores(queries: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """[Q, D] x [M, D] -> cosine [Q, M]; zero vectors score 0."""
    qn = queries / queries.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    mn = items / items.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return qn @ mn.T


def cosine_topk(
    queries: torch.Tensor, items: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact cosine top-k: ([Q, k] scores, [Q, k] indices)."""
    return torch.topk(cosine_scores(queries, items), k, dim=-1)

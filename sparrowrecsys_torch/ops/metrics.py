"""Streaming and exact binary-classification metrics.

The port of `sparrowrecsys_tpu/ops/metrics.py`. The reference compiles
every model with accuracy + ROC-AUC + PR-AUC (Keras's 200-threshold
streaming `AUC`); the streaming state here is a handful of float32
tensors that stay on the training device, so a step adds to it without a
round trip to the host. `exact_auc` is the sort-based host computation.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

NUM_THRESHOLDS = 200  # tf.keras.metrics.AUC default


class MetricState(NamedTuple):
    """Streaming confusion-matrix state at NUM_THRESHOLDS thresholds."""

    tp: torch.Tensor  # [T]
    fp: torch.Tensor  # [T]
    loss_sum: torch.Tensor  # []
    correct: torch.Tensor  # []
    pos: torch.Tensor  # [] total positives
    neg: torch.Tensor  # [] total negatives
    count: torch.Tensor  # [] total examples


def _thresholds(device) -> torch.Tensor:
    # Keras: [-eps, k/(T-1)..., 1+eps], equally spaced in (0, 1) plus sentinels.
    t = NUM_THRESHOLDS
    inner = (torch.arange(t - 2, dtype=torch.float32, device=device) + 1.0) / float(t - 1)
    return torch.cat([torch.tensor([-1e-7], device=device), inner,
                      torch.tensor([1.0 + 1e-7], device=device)])


def init_metrics(device=None) -> MetricState:
    t = NUM_THRESHOLDS
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)  # noqa: E731
    return MetricState(tp=z(t), fp=z(t), loss_sum=z(), correct=z(), pos=z(), neg=z(), count=z())


def update_metrics(
    state: MetricState,
    probs: torch.Tensor,
    labels: torch.Tensor,
    loss_sum: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> MetricState:
    """Accumulate one batch. probs/labels [B] float32; mask [B] or None."""
    if mask is None:
        mask = torch.ones_like(probs)
    labels = labels.float() * mask
    th = _thresholds(probs.device)
    pred_pos = (probs[None, :] > th[:, None]).float() * mask[None, :]
    tp = (pred_pos * labels[None, :]).sum(1)
    fp = (pred_pos * (mask - labels)[None, :]).sum(1)
    correct = (((probs > 0.5).float() == labels).float() * mask).sum()
    return MetricState(
        tp=state.tp + tp,
        fp=state.fp + fp,
        loss_sum=state.loss_sum + loss_sum,
        correct=state.correct + correct,
        pos=state.pos + labels.sum(),
        neg=state.neg + (mask - labels).sum(),
        count=state.count + mask.sum(),
    )


def finalize_metrics(state: MetricState) -> Dict[str, float]:
    """loss/accuracy/ROC-AUC/PR-AUC from the streaming state, as floats.

    ROC-AUC: trapezoidal over (FPR, TPR), Keras's 'interpolation'. PR-AUC:
    Keras's interpolated precision integral (Davis & Goadrich 2006)."""
    eps = 1e-7
    # float32, as the JAX package computes it on the device.
    tp, fp = state.tp.float().cpu(), state.fp.float().cpu()
    s = {k: v.float().cpu() for k, v in state._asdict().items()}
    pos = s["pos"].clamp_min(eps)
    tpr = tp / pos
    fpr = fp / s["neg"].clamp_min(eps)
    roc_auc = ((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) * 0.5).sum()
    dtp = tp[:-1] - tp[1:]
    p = tp + fp
    dp = p[:-1] - p[1:]
    prec_slope = dtp / dp.clamp_min(eps)
    intercept = tp[1:] - prec_slope * p[1:]
    both = (p[:-1] > 0) & (p[1:] > 0)
    ratio = torch.where(both, torch.log(p[:-1].clamp_min(eps) / p[1:].clamp_min(eps)),
                        torch.zeros_like(p[1:]))
    pr_auc = (prec_slope * (dtp + intercept * ratio) / pos).sum()
    count = s["count"].clamp_min(eps)
    return {
        "loss": float(s["loss_sum"] / count),
        "accuracy": float(s["correct"] / count),
        "roc_auc": float(roc_auc),
        "pr_auc": float(pr_auc),
    }


def exact_auc(probs: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
    """Exact ROC-AUC (Mann-Whitney, ties at their average rank) and PR-AUC
    (average precision) on the host."""
    probs = np.asarray(probs, np.float64)
    labels = np.asarray(labels, np.float64)
    order = np.argsort(-probs, kind="stable")
    y = labels[order]
    pos = y.sum()
    neg = len(y) - pos
    if pos == 0 or neg == 0:
        return {"roc_auc": float("nan"), "pr_auc": float("nan")}
    sorted_p = probs[order]
    n = len(probs)
    boundary = np.empty(n, dtype=bool)
    boundary[0] = True
    boundary[1:] = sorted_p[1:] != sorted_p[:-1]
    group = np.cumsum(boundary) - 1
    starts = np.flatnonzero(boundary)
    sizes = np.diff(np.append(starts, n))
    avg_rank = starts + (sizes + 1) / 2.0  # mean 1-based rank per tie group
    ranks = avg_rank[group]
    pos_ranks = ranks[y == 1].sum()
    roc = (pos * neg + pos * (pos + 1) / 2 - pos_ranks) / (pos * neg)
    tp = np.cumsum(y)
    precision = tp / np.arange(1, len(y) + 1)
    ap = (precision * y).sum() / pos
    return {"roc_auc": float(roc), "pr_auc": float(ap)}

"""DIN in plain PyTorch: the forward, the training loss, and Adam.

Follows the published model (SparrowRecSys `DIN.py`, after Zhou et al.,
"Deep Interest Network for Click-Through Rate Prediction",
arXiv:1706.06978) and the export format's parameter names (flax paths
joined by "/"):

- one movie table shared by the candidate and the history, id 0 (and an
  id past the table) a zero row; a user table; a genre table for
  userGenre1 and one for movieGenre1, genre -1 a zero row;
- the activation unit: for each history step h and the candidate c,
  [h - c, h, c, h * c] @ att_w1 + att_b1 -> PReLU(att_prelu) -> @ att_w2
  + att_b2 -> sigmoid, 0 for a step whose embedding row is all zero;
  pooled = sum_t w_t h_t;
- the tower on [user emb, userGenre1 emb, userRatingCount, userAvgRating,
  userRatingStddev, pooled, c, movieGenre1 emb, releaseYear,
  movieRatingCount, movieAvgRating, movieRatingStddev]: fc1 -> PReLU ->
  fc2 -> PReLU -> out, the logit. fc1 and fc2 compute in the stated
  `compute_dtype` (inputs, kernel and bias cast to it, the product
  rounded to it before the bias is added); `out` in float32;
- loss: the mean binary cross-entropy on the logits; Adam (optax's
  `scale_by_adam`, eps outside the square root) at the stated rates.

`precision="lower"` computes each product one step below the stated
precision: float32 products with their inputs rounded to TF32, bfloat16
products with theirs rounded to float8 e4m3. That is the control the
comparison has to catch.

Imports torch and nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import torch

USER_NUMERICS = ("userRatingCount", "userAvgRating", "userRatingStddev")
MOVIE_NUMERICS = ("releaseYear", "movieRatingCount", "movieAvgRating", "movieRatingStddev")
#: A configuration's `compute_dtype` -> the dtype the tower computes in.
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GENRES = 19


def param_shapes(dim: int, hidden: int, att: int, user_buckets: int,
                 movie_buckets: int) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of DIN by its export name."""
    width = (2 * dim + len(USER_NUMERICS)) + dim + dim + (dim + len(MOVIE_NUMERICS))
    return {
        "emb_movie_shared/table": (movie_buckets, dim),
        "att_w1": (4 * dim, att), "att_b1": (att,), "att_prelu": (att,),
        "att_w2": (att, 1), "att_b2": (1,),
        "emb_userId/table": (user_buckets, dim),
        "emb_userGenre1/table": (GENRES, dim),
        "emb_movieGenre1/table": (GENRES, dim),
        "fc1/kernel": (width, hidden), "fc1/bias": (hidden,), "prelu1/alpha": (hidden,),
        "fc2/kernel": (hidden, hidden // 2), "fc2/bias": (hidden // 2,),
        "prelu2/alpha": (hidden // 2,),
        "out/kernel": (hidden // 2, 1), "out/bias": (1,),
    }


def fc1_numeric_rows(dim: int) -> Dict[str, int]:
    """The row of fc1's kernel that each raw numeric column meets."""
    rows = {c: 2 * dim + i for i, c in enumerate(USER_NUMERICS)}
    base = 2 * dim + len(USER_NUMERICS) + 3 * dim
    rows.update({c: base + i for i, c in enumerate(MOVIE_NUMERICS)})
    return rows


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 to the nearest TF32 (10 mantissa bits), on the bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _lowered(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded one precision step below `dtype`, the gradient passed
    straight through."""
    if dtype == torch.float32:
        q = _round_tf32(x.detach().float())
    else:
        q = x.detach().to(torch.float8_e4m3fn).to(x.dtype)
    return x + (q - x).detach()


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "lower":
        a, b = _lowered(a, a.dtype), _lowered(b, b.dtype)
    return a @ b


def _dense(x, kernel, bias, dtype: torch.dtype, precision: str) -> torch.Tensor:
    if dtype == torch.float32:
        return _mm(x, kernel, precision) + bias
    return (_mm(x.to(dtype), kernel.to(dtype), precision) + bias.to(dtype)).float()


def _prelu(x, alpha):
    return torch.where(x >= 0, x, alpha * x)


def _lookup(table: torch.Tensor, ids: torch.Tensor, lo: int) -> torch.Tensor:
    v = table.shape[0]
    ids = ids.long()
    valid = (ids >= lo) & (ids < v)
    return table[ids.clamp(0, v - 1)] * valid.unsqueeze(-1).to(table.dtype)


def forward(w: Dict[str, torch.Tensor], feats: Dict[str, torch.Tensor], t: int,
            compute_dtype: torch.dtype, precision: str = "stated") -> torch.Tensor:
    """Logits [B] of a batch of feature columns (int ids, float numerics)."""
    movie = w["emb_movie_shared/table"]
    cand = _lookup(movie, feats["movieId"], 1)                             # [B, D]
    hist_ids = torch.stack([feats[f"userRatedMovie{k + 1}"] for k in range(t)], -1)
    hist = _lookup(movie, hist_ids, 1)                                     # [B, T, D]
    c = cand.unsqueeze(1).expand_as(hist)
    unit_in = torch.cat([hist - c, hist, c, hist * c], dim=-1)            # [B, T, 4D]
    a = _prelu(_mm(unit_in, w["att_w1"], precision) + w["att_b1"], w["att_prelu"])
    s = torch.sigmoid(_mm(a, w["att_w2"], precision) + w["att_b2"])         # [B, T, 1]
    live = (hist != 0).any(dim=-1, keepdim=True).to(s.dtype)
    pooled = (s * live * hist).sum(dim=1)                                  # [B, D]
    num = lambda cols: torch.stack([feats[k].float() for k in cols], -1)  # noqa: E731
    x = torch.cat([
        _lookup(w["emb_userId/table"], feats["userId"], 0),
        _lookup(w["emb_userGenre1/table"], feats["userGenre1"], 0),
        num(USER_NUMERICS), pooled, cand,
        _lookup(w["emb_movieGenre1/table"], feats["movieGenre1"], 0),
        num(MOVIE_NUMERICS)], dim=-1)
    x = _prelu(_dense(x, w["fc1/kernel"], w["fc1/bias"], compute_dtype, precision),
               w["prelu1/alpha"])
    x = _prelu(_dense(x, w["fc2/kernel"], w["fc2/bias"], compute_dtype, precision),
               w["prelu2/alpha"])
    return _dense(x, w["out/kernel"], w["out/bias"], torch.float32, precision)[..., 0]


def logits_in_blocks(w, feats, t, compute_dtype, precision="stated", block=65536):
    """`forward` without gradients over row blocks, so that it fits."""
    n = next(iter(feats.values())).shape[0]
    with torch.no_grad():
        return torch.cat([forward(w, {k: v[i:i + block] for k, v in feats.items()}, t,
                                  compute_dtype, precision) for i in range(0, n, block)])


def loss_and_grads(w, feats, labels, t, compute_dtype, precision="stated", block=8192):
    """(mean BCE over the batch, its gradient for every parameter), in
    row blocks whose gradients add up to the whole batch's."""
    n = labels.shape[0]
    leaves = {k: v.detach().requires_grad_() for k, v in w.items()}
    total = torch.zeros((), dtype=torch.float64, device=labels.device)
    for i in range(0, n, block):
        rows = {k: v[i:i + block] for k, v in feats.items()}
        logits = forward(leaves, rows, t, compute_dtype, precision)
        bce = torch.nn.functional.binary_cross_entropy_with_logits(
            logits, labels[i:i + block], reduction="sum")
        (bce / n).backward()
        total += bce.detach().double()
    grads = {k: v.grad if v.grad is not None else torch.zeros_like(v)
             for k, v in leaves.items()}
    return float(total / n), grads


class Adam:
    """optax `adam`: mu, nu, bias corrections, eps outside the root."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, b1: float, b2: float,
                 eps: float):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.count += 1
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                self.mu[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
                self.nu[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
                p.sub_(self.lr * (self.mu[k] / c1) / ((self.nu[k] / c2).sqrt() + self.eps))


def train_readings(w0: Dict[str, torch.Tensor], batches: Iterable[Tuple[dict, torch.Tensor]],
                   t: int, compute_dtype: torch.dtype, opt: dict,
                   precision: str = "stated") -> dict:
    """The readings of the first steps from the weights w0 (left as they
    are): each step's loss, each parameter's first gradient norm, and each
    parameter's change norm after the last step."""
    params = {k: v.detach().clone() for k, v in w0.items()}
    adam = Adam(params, opt["learning_rate"], opt["adam_b1"], opt["adam_b2"], opt["adam_eps"])
    losses: List[float] = []
    grad1: Dict[str, float] = {}
    for i, (feats, labels) in enumerate(batches):
        loss, grads = loss_and_grads(params, feats, labels, t, compute_dtype, precision)
        losses.append(loss)
        if i == 0:
            grad1 = {k: float(g.double().norm()) for k, g in grads.items()}
        adam.step(params, grads)
        del grads
    change = {k: float((params[k].double() - w0[k].double()).norm()) for k in w0}
    return {"loss": losses, "grad1": grad1, "change": change}


def worst_gap(prog: Dict[str, float], ref: Dict[str, float],
              keep: Iterable[str]) -> Tuple[float, str]:
    """(the widest gap between two norms of one leaf, over the kept leaves,
    against the larger of the reference's norm of that leaf and of the
    median leaf; the leaf)."""
    worst, leaf = 0.0, ""
    for k, gap in leaf_gaps(prog, ref, keep).items():
        if gap > worst or not leaf:
            worst, leaf = gap, k
    return worst, leaf


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Iterable[str]) -> Dict[str, float]:
    """Each kept leaf's gap between two norms, against the larger of the
    reference's norm of that leaf and of the median leaf."""
    keep = list(keep)
    norms = sorted(ref[k] for k in keep)
    median = norms[len(norms) // 2] if norms else 0.0
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in keep}


def median_gap(prog: Dict[str, float], ref: Dict[str, float], keep: Iterable[str]) -> float:
    """The median leaf's gap (`leaf_gaps`): steady from seed to seed, where
    the widest gap follows one small leaf."""
    gaps = sorted(leaf_gaps(prog, ref, keep).values())
    return gaps[len(gaps) // 2] if gaps else 0.0


def moved_leaves(grad1_ref: Dict[str, float]) -> List[str]:
    """The leaves whose first gradient in the reference is at least a
    thousandth of the median leaf's; the others move by round-off alone."""
    norms = sorted(grad1_ref.values())
    median = norms[len(norms) // 2]
    return [k for k, v in grad1_ref.items() if v >= 1e-3 * median]


def truncated_normal(n: int, generator: torch.Generator, device) -> torch.Tensor:
    """n draws of N(0, 1) truncated to [-2, 2], by the inverse CDF."""
    lo, hi = [0.5 * (1 + math.erf(x / math.sqrt(2))) for x in (-2.0, 2.0)]
    u = torch.rand(n, generator=generator, device=device, dtype=torch.float32)
    return (torch.erfinv(2 * (lo + u * (hi - lo)) - 1) * math.sqrt(2)).clamp_(-2, 2)

"""DIEN in plain PyTorch: the forward, the training objective, its
gradients by autograd, and Adam.

Follows the model SparrowRecSys publishes (`TFRecModel/src/com/
sparrowrecsys/offline/tensorflow/DIEN.py`, after Zhou et al., "Deep
Interest Evolution Network for Click-Through Rate Prediction",
arXiv:1809.03672) and the export format's parameter names (flax paths
joined by "/"):

- one movie table (`mask_zero`) shared by the candidate, the history and
  the per-step negatives, id 0 (and an id past the table) a zero row; a
  user table; a genre table for userGenre1 and one for movieGenre1,
  genre -1 a zero row (DIEN.py:162-178);
- the interest extractor (DIEN.py:181): a GRU of width D over the
  history, returning every state from h0 = 0; a step whose history id is
  0 carries the state (the Embedding's mask);
- the attention (DIEN.py:184-213): sigmoid(Dense(32)) then
  sigmoid(Dense(1)) of each state times the candidate, one scalar a step;
- the interest evolution (DIEN.py:217-262): the AUGRU over the states,
  h <- (1 - a r) h + a r h~ with r = sigmoid(x W_r + b_r + h U_r),
  z = sigmoid(x W_z + b_z + h U_z), h~ = tanh(x W_h + b_h + (h z) U_h),
  from h0 = 0, its final state the interest;
- the tower on [interest, candidate, user emb, userGenre1 emb,
  userRatingCount, userAvgRating, userRatingStddev, movieGenre1 emb,
  releaseYear, movieRatingCount, movieAvgRating, movieRatingStddev]:
  Dense(128) -> PReLU -> Dense(64) -> PReLU -> Dense(1), the logit
  (DIEN.py:266-272);
- the auxiliary heads (DIEN.py:275-308): sigmoid(Dense(1)) of
  sigmoid(Dense(32)) of [state_t, history_{t+1}] and of [state_t,
  negative_{t+1}] for t < T, aux = the sum over t of both scores;
- the objective: the mean over the batch of BCE(label, logit) - alpha *
  aux, alpha = 0.5 (DIEN.py:303-305: mean BCE - alpha * mean aux);
- Adam at Keras's defaults, as optax's `scale_by_adam` computes it (eps
  outside the square root).

Departures from DIEN.py:
- The GRU applies its reset gate before the recurrent product, with one
  bias [3D]: z = sigmoid(x W_z + h U_z + b_z), r = sigmoid(x W_r + h U_r +
  b_r), h~ = tanh(x W_h + (r h) U_h + b_h), h' = z h + (1 - z) h~, the form
  the program and the JAX package it was ported from compute. Keras's
  `GRU` under TensorFlow 2 defaults to `reset_after=True`, the reset gate
  applied after the product, with a second, recurrent bias.
- The negatives are data: the caller's `negativeUserRatedMovie2..T`
  columns, where DIEN.py draws them while it reads its CSV.

`precision="lower"` rounds the inputs of every product (the projections,
the recurrent products, the attention, the tower, the heads) to TF32,
one step below float32. That is the control the comparison has to catch.

Plain `torch` in float32, TF32 products off; imports nothing else.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch

USER_NUMERICS = ("userRatingCount", "userAvgRating", "userRatingStddev")
MOVIE_NUMERICS = ("releaseYear", "movieRatingCount", "movieAvgRating", "movieRatingStddev")
GENRES = 19
#: The width of the attention's and the auxiliary heads' first layer.
HEAD = 32


def no_tf32() -> None:
    """float32 products in float32, on the card as on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def param_shapes(dim: int, hidden: int, user_buckets: int,
                 movie_buckets: int) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of DIEN by its export name; kernels [in, out]."""
    d = dim
    width = d + d + (2 * d + len(USER_NUMERICS)) + (d + len(MOVIE_NUMERICS))
    shapes = {
        "emb_movie_shared/table": (movie_buckets, d),
        "gru_kernel": (d, 3 * d), "gru_recurrent": (d, 3 * d), "gru_bias": (3 * d,),
        "att_dense32/kernel": (d, HEAD), "att_dense32/bias": (HEAD,),
        "att_dense1/kernel": (HEAD, 1), "att_dense1/bias": (1,),
    }
    for g in "rzh":
        shapes.update({f"augru_{g}_w": (d, d), f"augru_{g}_b": (d,), f"augru_{g}_u": (d, d)})
    shapes.update({
        "emb_userId/table": (user_buckets, d),
        "emb_userGenre1/table": (GENRES, d),
        "emb_movieGenre1/table": (GENRES, d),
        "fc1/kernel": (width, hidden), "fc1/bias": (hidden,), "prelu1/alpha": (hidden,),
        "fc2/kernel": (hidden, hidden // 2), "fc2/bias": (hidden // 2,),
        "prelu2/alpha": (hidden // 2,),
        "out/kernel": (hidden // 2, 1), "out/bias": (1,),
    })
    for head in ("pos", "neg"):
        shapes.update({f"aux_{head}32/kernel": (2 * d, HEAD), f"aux_{head}32/bias": (HEAD,),
                       f"aux_{head}1/kernel": (HEAD, 1), f"aux_{head}1/bias": (1,)})
    return shapes


def fc1_numeric_rows(dim: int) -> Dict[str, int]:
    """The row of fc1's kernel that each raw numeric column meets."""
    rows = {c: 4 * dim + i for i, c in enumerate(USER_NUMERICS)}
    base = 4 * dim + len(USER_NUMERICS) + dim
    rows.update({c: base + i for i, c in enumerate(MOVIE_NUMERICS)})
    return rows


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 to the nearest TF32 (10 mantissa bits), on the bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _lowered(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32, the gradient passed straight through."""
    return x + (_round_tf32(x.detach().float()) - x).detach()


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "lower":
        a, b = _lowered(a), _lowered(b)
    return a @ b


def _prelu(x, alpha):
    return torch.where(x >= 0, x, alpha * x)


def _lookup(table: torch.Tensor, ids: torch.Tensor, lo: int) -> torch.Tensor:
    v = table.shape[0]
    ids = ids.long()
    valid = (ids >= lo) & (ids < v)
    return table[ids.clamp(0, v - 1)] * valid.unsqueeze(-1).to(table.dtype)


def _gru(w, x, mask, precision):
    """The states [B, T, D] of the masked GRU over x [B, T, D]."""
    d = x.shape[-1]
    u = w["gru_recurrent"]
    gx = _mm(x, w["gru_kernel"], precision) + w["gru_bias"]
    h = x.new_zeros(x.shape[0], d)
    states = []
    for g, m in zip(gx.unbind(1), mask.unbind(1)):
        z = torch.sigmoid(g[:, :d] + _mm(h, u[:, :d], precision))
        r = torch.sigmoid(g[:, d:2 * d] + _mm(h, u[:, d:2 * d], precision))
        hh = torch.tanh(g[:, 2 * d:] + _mm(r * h, u[:, 2 * d:], precision))
        h = torch.where(m[:, None], z * h + (1.0 - z) * hh, h)
        states.append(h)
    return torch.stack(states, 1)


def _augru(w, states, att, precision):
    """The final state [B, D] of the AUGRU over states [B, T, D] with the
    attention att [B, T]."""
    proj = {g: _mm(states, w[f"augru_{g}_w"], precision) + w[f"augru_{g}_b"] for g in "rzh"}
    h = states.new_zeros(states.shape[0], states.shape[-1])
    for xr, xz, xh, a in zip(proj["r"].unbind(1), proj["z"].unbind(1), proj["h"].unbind(1),
                             att.unbind(1)):
        r = torch.sigmoid(xr + _mm(h, w["augru_r_u"], precision))
        z = torch.sigmoid(xz + _mm(h, w["augru_z_u"], precision))
        ht = torch.tanh(xh + _mm(h * z, w["augru_h_u"], precision))
        ar = a[:, None] * r
        h = (1.0 - ar) * h + ar * ht
    return h


def _head(w, name, x, precision):
    """sigmoid(Dense(1)) of sigmoid(Dense(32)) of x [..., 2D] -> [...]."""
    y = torch.sigmoid(_mm(x, w[f"aux_{name}32/kernel"], precision) + w[f"aux_{name}32/bias"])
    return torch.sigmoid(_mm(y, w[f"aux_{name}1/kernel"], precision)
                         + w[f"aux_{name}1/bias"])[..., 0]


def forward(w: Dict[str, torch.Tensor], feats: Dict[str, torch.Tensor], t: int,
            precision: str = "stated") -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits [B], aux [B]) of a batch of feature columns (int ids, float
    numerics, the negatives `negativeUserRatedMovie2..T`)."""
    movie = w["emb_movie_shared/table"]
    cand = _lookup(movie, feats["movieId"], 1)                             # [B, D]
    hist_ids = torch.stack([feats[f"userRatedMovie{k + 1}"] for k in range(t)], -1)
    hist = _lookup(movie, hist_ids, 1)                                     # [B, T, D]
    neg_ids = torch.stack([feats[f"negativeUserRatedMovie{k}"] for k in range(2, t + 1)], -1)
    neg = _lookup(movie, neg_ids, 1)                                       # [B, T-1, D]
    states = _gru(w, hist, hist_ids > 0, precision)                         # [B, T, D]
    att = torch.sigmoid(_mm(states * cand[:, None], w["att_dense32/kernel"], precision)
                        + w["att_dense32/bias"])
    att = torch.sigmoid(_mm(att, w["att_dense1/kernel"], precision)
                        + w["att_dense1/bias"])[..., 0]                    # [B, T]
    interest = _augru(w, states, att, precision)                           # [B, D]
    num = lambda cols: torch.stack([feats[k].float() for k in cols], -1)  # noqa: E731
    x = torch.cat([
        interest, cand,
        _lookup(w["emb_userId/table"], feats["userId"], 0),
        _lookup(w["emb_userGenre1/table"], feats["userGenre1"], 0),
        num(USER_NUMERICS),
        _lookup(w["emb_movieGenre1/table"], feats["movieGenre1"], 0),
        num(MOVIE_NUMERICS)], dim=-1)
    x = _prelu(_mm(x, w["fc1/kernel"], precision) + w["fc1/bias"], w["prelu1/alpha"])
    x = _prelu(_mm(x, w["fc2/kernel"], precision) + w["fc2/bias"], w["prelu2/alpha"])
    logits = (_mm(x, w["out/kernel"], precision) + w["out/bias"])[..., 0]
    prev = states[:, :t - 1]
    pos = _head(w, "pos", torch.cat([prev, hist[:, 1:]], -1), precision)    # [B, T-1]
    negs = _head(w, "neg", torch.cat([prev, neg], -1), precision)
    return logits, (pos + negs).sum(1)


def objective(logits, aux, labels, alpha: float) -> torch.Tensor:
    """Per example: BCE(label, logit) - alpha * aux."""
    bce = torch.nn.functional.binary_cross_entropy_with_logits(logits, labels, reduction="none")
    return bce - alpha * aux


def loss_and_grads(w, feats, labels, t, alpha, precision="stated", block=16384):
    """(the objective's mean over the batch, its gradient for every
    parameter), in row blocks whose gradients add up to the whole batch's."""
    n = labels.shape[0]
    leaves = {k: v.detach().requires_grad_() for k, v in w.items()}
    total = torch.zeros((), dtype=torch.float64, device=labels.device)
    for i in range(0, n, block):
        rows = {k: v[i:i + block] for k, v in feats.items()}
        logits, aux = forward(leaves, rows, t, precision)
        part = objective(logits, aux, labels[i:i + block], alpha).sum()
        (part / n).backward()
        total += part.detach().double()
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
                   t: int, alpha: float, opt: dict, precision: str = "stated") -> dict:
    """The readings of the first steps from the weights w0 (left as they
    are): each step's loss, each parameter's first gradient norm, and each
    parameter's change norm after the last step."""
    no_tf32()
    params = {k: v.detach().clone() for k, v in w0.items()}
    adam = Adam(params, opt["learning_rate"], opt["adam_b1"], opt["adam_b2"], opt["adam_eps"])
    losses: List[float] = []
    grad1: Dict[str, float] = {}
    for i, (feats, labels) in enumerate(batches):
        loss, grads = loss_and_grads(params, feats, labels, t, alpha, precision)
        losses.append(loss)
        if i == 0:
            grad1 = {k: float(g.double().norm()) for k, g in grads.items()}
        adam.step(params, grads)
        del grads
    change = {k: float((params[k].double() - w0[k].double()).norm()) for k in w0}
    return {"loss": losses, "grad1": grad1, "change": change}


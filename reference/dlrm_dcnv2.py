"""DLRM-DCNv2 in plain PyTorch: the forward, the loss, its gradients by
autograd, and the optimizer.

Follows the model of the MLPerf Training recommendation benchmark
(MLCommons `recommendation_v2/torchrec_dlrm`, TorchRec's `DLRM_DCN`, after
Wang et al., "DCN V2", arXiv:2008.13535), under the program's parameter
names (`state_dict` names):

- dense arch: d = ReLU(L3(ReLU(L2(ReLU(L1(x_dense)))))), `bottom.i.weight`
  [out, in] and `bottom.i.bias`;
- sparse arch: for each feature f, e_f = the sum over its k_f ids j of
  T_f[id_{f,j}] (`emb_cat_f.table`; an id outside the table a zero row);
- interaction: x0 = flatten([d, e_0, ..., e_25]); for each cross layer l,
  x_{l+1} = x0 * (x_l V_l W_l + b_l) + x_l, V_l = `cross.l.v` [27 D,
  rank], W_l = `cross.l.w` [rank, 27 D], b_l = `cross.l.b`;
- over arch: ReLU after every `top.i` layer but the last, whose one
  output is the logit;
- loss: binary cross-entropy with logits, the mean over the batch.

The optimizer is Adam as the program's trainer computes it
(`training/optim.py`: mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2,
p -= lr (mu / c1) / (sqrt(nu / c2) + eps), eps 1e-7, c1 and c2 from the
global step count in float32). The tables named `sparse` take it lazily:
a step updates only the rows its ids touch, and the other rows' moments
stay as they are (not decayed); every other parameter takes it densely.

Departures from the published recipe:
- Adam in place of the reference's row-wise Adagrad (as recalled, not
  checked here): the program's trainer has Adam only. A fixed learning
  rate, no warm-up or decay.
- The five 40,000,000-row tables held at fewer rows (a configuration's
  `table_rows`), their ids drawn from the rows held.
- A table may be held in part: the caller passes only the rows the steps
  touch, with the ids remapped onto them. Under lazy Adam an untouched row
  never changes, so this is exact.

`precision="lower"` rounds the inputs of every product (the three MLP
stacks and the cross layers) to TF32, one step below float32, the
gradient passed straight through. That is the control the comparison has
to catch.

Plain `torch` in float32, TF32 products off (`no_tf32`); imports nothing
else.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import torch
import torch.nn.functional as F

DENSE_FEATURES = 13


def no_tf32() -> None:
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def param_shapes(dim: int, dense_sizes: Sequence[int], over_sizes: Sequence[int],
                 cross_layers: int, cross_rank: int,
                 table_rows: Sequence[int]) -> Dict[str, Tuple[int, ...]]:
    """Every parameter by its name, tables at `table_rows`."""
    out: Dict[str, Tuple[int, ...]] = {}
    widths = (DENSE_FEATURES, *dense_sizes)
    for i, (a, b) in enumerate(zip(widths, widths[1:])):
        out[f"bottom.{i}.weight"], out[f"bottom.{i}.bias"] = (b, a), (b,)
    for f, rows in enumerate(table_rows):
        out[f"emb_cat_{f}.table"] = (rows, dim)
    width = (len(table_rows) + 1) * dim
    for i in range(cross_layers):
        out[f"cross.{i}.v"], out[f"cross.{i}.w"] = (width, cross_rank), (cross_rank, width)
        out[f"cross.{i}.b"] = (width,)
    widths = (width, *over_sizes)
    for i, (a, b) in enumerate(zip(widths, widths[1:])):
        out[f"top.{i}.weight"], out[f"top.{i}.bias"] = (b, a), (b,)
    return out


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 to the nearest TF32 (10 mantissa bits), on the bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _lowered(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32, the gradient passed straight through."""
    return x + (_round_tf32(x.detach()) - x).detach()


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "lower":
        a, b = _lowered(a), _lowered(b)
    return a @ b


def _stack(w, prefix: str, x: torch.Tensor, relu_last: bool, precision: str) -> torch.Tensor:
    n = sum(1 for k in w if k.startswith(prefix) and k.endswith(".weight"))
    for i in range(n):
        x = _mm(x, w[f"{prefix}{i}.weight"].T, precision) + w[f"{prefix}{i}.bias"]
        if relu_last or i < n - 1:
            x = torch.relu(x)
    return x


def _pooled(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The sum of the rows of each example's ids [B, k], a zero row for an
    id outside the table."""
    v = table.shape[0]
    ids = ids.long()
    valid = (ids >= 0) & (ids < v)
    return (table[ids.clamp(0, v - 1)] * valid.unsqueeze(-1).to(table.dtype)).sum(1)


def n_tables(w: Dict[str, torch.Tensor]) -> int:
    return sum(1 for k in w if k.startswith("emb_cat_"))


def forward(w: Dict[str, torch.Tensor], feats: Dict[str, torch.Tensor],
            precision: str = "stated") -> torch.Tensor:
    """Logits [B] of a batch: `dense` [B, 13], `cat_f` [B, k_f] ids."""
    d = _stack(w, "bottom.", feats["dense"].float(), True, precision)
    pooled = [_pooled(w[f"emb_cat_{f}.table"], feats[f"cat_{f}"]) for f in range(n_tables(w))]
    x0 = torch.stack([d, *pooled], dim=1).flatten(1)
    x = x0
    layers = sum(1 for k in w if k.startswith("cross.") and k.endswith(".b"))
    for i in range(layers):
        x = x0 * (_mm(_mm(x, w[f"cross.{i}.v"], precision), w[f"cross.{i}.w"], precision)
                  + w[f"cross.{i}.b"]) + x
    return _stack(w, "top.", x, False, precision)[..., 0]


def loss_and_grads(w: Dict[str, torch.Tensor], feats: Dict[str, torch.Tensor],
                   labels: torch.Tensor, precision: str = "stated",
                   block: int = 2048) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(mean BCE over the batch, its gradient for every parameter), in row
    blocks whose gradients add up to the whole batch's."""
    n = labels.shape[0]
    leaves = {k: v.detach().requires_grad_() for k, v in w.items()}
    total = torch.zeros((), dtype=torch.float64, device=labels.device)
    for i in range(0, n, block):
        rows = {k: v[i:i + block] for k, v in feats.items()}
        bce = F.binary_cross_entropy_with_logits(forward(leaves, rows, precision),
                                                 labels[i:i + block], reduction="sum")
        (bce / n).backward()
        total += bce.detach().double()
    grads = {k: v.grad if v.grad is not None else torch.zeros_like(v)
             for k, v in leaves.items()}
    return float(total / n), grads


class Adam:
    """Adam on every parameter; on the tables in `sparse` lazily, the rows
    a step touches alone."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, b1: float, b2: float,
                 eps: float, sparse: Iterable[str] = ()):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.sparse = set(sparse)
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             touched: Dict[str, torch.Tensor]) -> None:
        """One step; `touched[k]`: the distinct rows of sparse table k that
        the step's ids touch."""
        self.count += 1
        t = torch.tensor(float(self.count))
        c1, c2 = float(1 - self.b1 ** t), float(1 - self.b2 ** t)
        with torch.no_grad():
            for k, p in params.items():
                rows = touched[k] if k in self.sparse else slice(None)
                g, mu, nu = grads[k][rows], self.mu[k][rows], self.nu[k][rows]
                mu = self.b1 * mu + (1 - self.b1) * g
                nu = self.b2 * nu + (1 - self.b2) * g * g
                self.mu[k][rows], self.nu[k][rows] = mu, nu
                p[rows] = p[rows] - self.lr * (mu / c1) / ((nu / c2).sqrt() + self.eps)


def touched_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The distinct rows of `table` that `ids` name, ids outside it left out."""
    ids = ids.reshape(-1).long()
    return torch.unique(ids[(ids >= 0) & (ids < table.shape[0])])


def train_readings(w0: Dict[str, torch.Tensor], batches: Iterable[Tuple[dict, torch.Tensor]],
                   sparse: Iterable[str], opt: dict, precision: str = "stated") -> dict:
    """The readings of the first steps from the weights w0 (left as they
    are): each step's loss, each parameter's first gradient norm, and each
    parameter's change norm after the last step. `sparse`: the tables
    (`emb_cat_f.table`) that take lazy Adam."""
    no_tf32()
    params = {k: v.detach().clone() for k, v in w0.items()}
    sparse = list(sparse)
    adam = Adam(params, opt["learning_rate"], opt["adam_b1"], opt["adam_b2"], opt["adam_eps"],
                sparse)
    losses: List[float] = []
    grad1: Dict[str, float] = {}
    for i, (feats, labels) in enumerate(batches):
        loss, grads = loss_and_grads(params, feats, labels, precision)
        losses.append(loss)
        if i == 0:
            grad1 = {k: float(g.double().norm()) for k, g in grads.items()}
        col = {k: feats[k[len("emb_"):-len(".table")]] for k in sparse}
        adam.step(params, grads, {k: touched_rows(params[k], col[k]) for k in sparse})
        del grads
    change = {k: float((params[k].double() - w0[k].double()).norm()) for k in w0}
    return {"loss": losses, "grad1": grad1, "change": change}

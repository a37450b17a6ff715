"""The training loop: the port of `sparrowrecsys_tpu/training/loop.py`.

Replaces the reference's Keras `compile(loss='binary_crossentropy',
optimizer='adam', metrics=[accuracy, ROC-AUC, PR-AUC]); fit(...)` with:

- one train step: forward + BCE + group-fused Adam (`training/optim.py`)
  + streaming metrics kept on the device (`ops/metrics.py`);
- the epoch's rows in a given order, padded with dataset row 0 to whole
  batches and masked, as the JAX package's resident epoch does
  (`loop.py:255-265`): the padded rows' ids still count as touched rows of
  a sparse table, so their lazy-Adam moments decay;
- `sparse_tables`: the named embedding tables leave the dense optimizer
  and live in a fused [V, 3D] row-Adam buffer (`training/row_optim.py`);
  the step differentiates the buffer's table view and updates only the
  touched rows, through the row kernels on the card.

Parameters are a dict of tensors keyed by `state_dict` name, applied with
`torch.func.functional_call`; `checkpoint.params_to_flax` turns one into
the JAX package's tree. A `loss_fn` (DIEN's `dien_loss_fn`) takes the
JAX protocol (`loop.py:76-82`, `:350-363`):
`loss_fn(forward, params, feats, labels, mask[, generator])` ->
(loss, (logits, summed masked objective)), with a per-step
`torch.Generator` when `loss_fn.wants_rng`. Not ported yet, raising
NotImplementedError (and queued in ROADMAP.md): mesh plans, and
train-state checkpoints and resume.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from sparrowrecsys_torch.config import TrainConfig
from sparrowrecsys_torch.data.dataset import EncodedDataset
from sparrowrecsys_torch.models.features import flax_init
from sparrowrecsys_torch.ops import metrics as M
from sparrowrecsys_torch.training.optim import grouped_adam
from sparrowrecsys_torch.training.row_optim import (
    fused_row_adam_update,
    fused_table,
    init_fused_row_adam,
)
from sparrowrecsys_torch.utils.device import resolve_device


@dataclasses.dataclass
class TrainResult:
    params: Dict[str, torch.Tensor]
    history: list  # per-epoch dicts of train metrics
    eval_metrics: Optional[Dict[str, float]] = None
    examples_per_sec: float = 0.0
    #: the optimizer state after the last step (with `sparse_tables`, its
    #: "rows" hold the fused [V, 3D] row-Adam buffers).
    opt_state: Any = None


def _default_loss(logits, labels, mask):
    """Masked mean binary cross-entropy on logits (optax's
    `sigmoid_binary_cross_entropy`); returns (loss, summed masked BCE)."""
    bce = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
    loss_sum = (bce * mask).sum()
    return loss_sum / mask.sum().clamp_min(1.0), loss_sum


def _queued(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet; it is queued in ROADMAP.md")


class Trainer:
    """Generic CTR trainer for a model mapping a feature dict to logits [B]
    (or to (logits, aux) under a `loss_fn`, e.g. DIEN's).

    `device` defaults to cuda (`utils/device.py::resolve_device`); the
    CPU only when asked for."""

    def __init__(
        self,
        model: torch.nn.Module,
        config: Optional[TrainConfig] = None,
        plan=None,
        loss_fn=None,
        sparse_tables: Optional[Dict[str, tuple]] = None,
        device=None,
    ):
        if plan is not None:
            raise _queued("training over a device mesh (MeshPlan)")
        self.loss_fn = loss_fn
        self.config = config or TrainConfig()
        if self.config.shuffle_mode != "exact":
            raise _queued("shuffle_mode='blocks' (the TPU layout's block shuffle)")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        #: {param module name: (feature columns gathering from it, ...)},
        #: e.g. {"emb_userId": ("userId",)}: those tables take the lazy
        #: row-Adam (untouched rows' moments freeze rather than decay).
        self.sparse_tables = {
            k: tuple(v) if not isinstance(v, str) else (v,)
            for k, v in (sparse_tables or {}).items()
        }
        self._table_keys = {f"{mod}.table" for mod in self.sparse_tables}
        cfg = self.config
        self.tx = grouped_adam(cfg.learning_rate, b1=cfg.adam_b1, b2=cfg.adam_b2,
                               eps=cfg.adam_eps)
        #: Datasets at most this large are uploaded to the device once per
        #: fit; larger ones upload each batch.
        self.device_resident_bytes = 2 << 30

    # ------------------------------------------------------------------
    def _dense_view(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Sparse tables replaced by empty placeholders, so the dense
        optimizer neither stores nor updates state for them."""
        out = dict(params)
        for mod in self.sparse_tables:
            out[f"{mod}.table"] = torch.zeros(0, dtype=torch.float32, device=self.device)
        return out

    def init_opt_state(self, params: Dict[str, torch.Tensor]):
        """The dense optimizer's state, plus a fused [V, 3D] row-Adam buffer
        per sparse table (the table moves into the buffer)."""
        if not self.sparse_tables:
            return self.tx.init(params)
        return {
            "dense": self.tx.init(self._dense_view(params)),
            "rows": {mod: init_fused_row_adam(params[f"{mod}.table"])
                     for mod in self.sparse_tables},
        }

    def _materialize_tables(self, params, opt_state) -> Dict[str, torch.Tensor]:
        """Copy each table out of its fused buffer back into the params."""
        out = dict(params)
        for mod in self.sparse_tables:
            out[f"{mod}.table"] = fused_table(opt_state["rows"][mod]).contiguous()
        return out

    # ------------------------------------------------------------------
    def init_params(self, sample_feats=None, seed: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Fresh parameters drawn from the flax initialisers' distributions
        (`models/features.py::flax_init`) by a generator seeded with
        `seed` (default `TrainConfig.seed`). `sample_feats` is accepted
        for the JAX signature; the shapes come from the model."""
        seed = self.config.seed if seed is None else seed
        return flax_init(self.model, torch.Generator().manual_seed(seed), self.device)

    # ------------------------------------------------------------------
    def _forward(self, params, feats):
        return functional_call(self.model, params, (feats,), strict=True)

    def _loss(self, leaves, feats, labels, mask, generator=None):
        """(loss, logits, summed masked objective) of one batch: the masked
        mean BCE, or `loss_fn`'s objective."""
        if self.loss_fn is None:
            logits = self._forward(leaves, feats)
            loss, loss_sum = _default_loss(logits, labels, mask)
            return loss, logits, loss_sum
        rng = (generator,) if getattr(self.loss_fn, "wants_rng", False) else ()
        loss, (logits, loss_sum) = self.loss_fn(self._forward, leaves, feats, labels, mask, *rng)
        return loss, logits, loss_sum

    def step_generator(self, epoch: int, step: int) -> torch.Generator:
        """The generator a `wants_rng` loss draws from in one step, on the
        device, seeded from (seed + epoch, step)."""
        seed = np.random.SeedSequence([self.config.seed + epoch, 0x6E6567, step])
        return torch.Generator(device=self.device).manual_seed(int(seed.generate_state(1)[0]))

    def _diff_leaves(self, params, opt_state):
        """The tensors a step differentiates, keyed by state_dict name:
        the dense params and, for each sparse table, its fused buffer's
        [V, D] table view (a strided view, no copy)."""
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()
                  if k not in self._table_keys}
        for mod in self.sparse_tables:
            leaves[f"{mod}.table"] = fused_table(opt_state["rows"][mod]).detach().requires_grad_()
        return leaves

    def loss_and_grads(self, params, opt_state, feats, labels, mask, generator=None):
        """Forward and backward of one batch: (logits, loss, summed masked
        objective, gradients keyed by state_dict name; a sparse table's is
        its dense [V, D] gradient)."""
        leaves = self._diff_leaves(params, opt_state)
        loss, logits, loss_sum = self._loss(leaves, feats, labels, mask, generator)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        return logits.detach(), loss.detach(), loss_sum.detach(), grads

    @torch.no_grad()
    def apply_grads(self, params, opt_state, grads, feats):
        """The optimizer step: group-fused Adam on the dense params (in
        place) and the lazy row-Adam on each sparse table's touched rows
        (in place in its buffer). Returns (params, opt_state)."""
        cfg = self.config
        if self.sparse_tables:
            # The placeholders' (empty) gradients ride along, in the
            # order the dense state was initialised with.
            gdense = {k: v if k in self._table_keys else grads[k] for k, v in params.items()}
            updates, dstate = self.tx.update(gdense, opt_state["dense"])
            rows = {}
            for mod, cols in self.sparse_tables.items():
                ids = torch.cat([feats[c].reshape(-1).to(torch.int32) for c in cols])
                rows[mod] = fused_row_adam_update(
                    opt_state["rows"][mod], grads[f"{mod}.table"], ids,
                    learning_rate=cfg.learning_rate, b1=cfg.adam_b1,
                    b2=cfg.adam_b2, eps=cfg.adam_eps,
                )
            opt_state = {"dense": dstate, "rows": rows}
        else:
            updates, opt_state = self.tx.update(grads, opt_state)
        for k, v in params.items():
            if k not in self._table_keys:
                v.add_(updates[k])
        return params, opt_state

    def _train_step(self, params, opt_state, mstate, feats, labels, mask, generator=None):
        """One step; updates `params` (and sparse buffers) in place and
        returns (params, opt_state, mstate)."""
        logits, _, loss_sum, grads = self.loss_and_grads(
            params, opt_state, feats, labels, mask, generator)
        params, opt_state = self.apply_grads(params, opt_state, grads, feats)
        mstate = M.update_metrics(mstate, torch.sigmoid(logits), labels, loss_sum, mask)
        return params, opt_state, mstate

    # ------------------------------------------------------------------
    def _epoch_order(self, n: int, padded: int, epoch: int, orders) -> tuple:
        """(row order [padded] int64, valid mask [padded] float32) on the
        device: `orders[epoch]` when given, else a permutation from a
        generator seeded with seed + epoch (arange without shuffle), its
        tail padded with row 0 (`loop.py:255-265`)."""
        cfg = self.config
        if orders is not None:
            order = torch.from_numpy(np.array(orders[epoch], dtype=np.int64))
            if order.shape != (n,):
                raise ValueError(f"orders[{epoch}] has shape {tuple(order.shape)}, want ({n},)")
        elif cfg.shuffle_each_epoch:
            order = torch.randperm(n, generator=torch.Generator().manual_seed(cfg.seed + epoch))
        else:
            order = torch.arange(n)
        order = torch.cat([order, torch.zeros(padded - n, dtype=torch.int64)])
        valid = torch.arange(padded) < n
        return order.to(self.device), valid.float().to(self.device)

    def _columns(self, ds: EncodedDataset):
        """The dataset's columns and labels as tensors: on the device when
        they fit `device_resident_bytes`, else on the host."""
        nbytes = sum(v.nbytes for v in ds.features.values()) + ds.labels.nbytes
        dev = self.device if nbytes <= self.device_resident_bytes else torch.device("cpu")
        cols = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in ds.features.items()}
        return cols, torch.from_numpy(np.ascontiguousarray(ds.labels)).to(dev)

    def _gather(self, cols, labels, idx):
        idx = idx.to(labels.device)
        feats = {k: v[idx].to(self.device, non_blocking=True) for k, v in cols.items()}
        return feats, labels[idx].to(self.device, non_blocking=True)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(
        self,
        train: EncodedDataset,
        test: Optional[EncodedDataset] = None,
        params: Optional[Dict[str, torch.Tensor]] = None,
        epochs: Optional[int] = None,
        batch_size: Optional[int] = None,
        verbose: bool = True,
        state_dir: Optional[str] = None,
        resume: bool = False,
        orders: Optional[Sequence[Any]] = None,
    ) -> TrainResult:
        """Train; returns a TrainResult with the steady-state examples/s
        (the epochs after the first, or the whole run when it has one).

        `orders`: an optional row order per epoch (`orders[epoch]`, n row
        indices), e.g. the JAX package's
        `jax.random.permutation(PRNGKey(seed + epoch), n)`; without it the
        order comes from a torch.Generator seeded with seed + epoch.
        The caller's `params` are copied, not changed."""
        if state_dir is not None or resume:
            raise _queued("train-state checkpointing and resume (state_dir/resume)")
        cfg = self.config
        epochs = cfg.epochs if epochs is None else epochs
        batch_size = cfg.batch_size if batch_size is None else batch_size
        if params is None:
            params = self.init_params(train.features)
        params = {k: v.to(self.device, torch.float32).clone() for k, v in params.items()}
        opt_state = self.init_opt_state(params)
        if self.sparse_tables:
            params = self._dense_view(params)

        cols, labels_all = self._columns(train)
        n = len(train)
        steps = -(-n // batch_size)
        padded = steps * batch_size
        wants_rng = bool(getattr(self.loss_fn, "wants_rng", False))
        history = []
        timed_examples = 0
        t0 = time.perf_counter()
        t_steady = None
        for epoch in range(epochs):
            mstate = M.init_metrics(self.device)
            order, valid = self._epoch_order(n, padded, epoch, orders)
            for s in range(steps):
                sl = slice(s * batch_size, (s + 1) * batch_size)
                feats, labels = self._gather(cols, labels_all, order[sl])
                gen = self.step_generator(epoch, s) if wants_rng else None
                params, opt_state, mstate = self._train_step(
                    params, opt_state, mstate, feats, labels, valid[sl], gen)
            if t_steady is None:
                self._sync()
                t_steady = time.perf_counter()
            else:
                timed_examples += n
            history.append(M.finalize_metrics(mstate))
            if verbose:
                em = history[-1]
                print(f"epoch {epoch + 1}/{epochs}: loss={em['loss']:.4f} "
                      f"acc={em['accuracy']:.4f} roc_auc={em['roc_auc']:.4f} "
                      f"pr_auc={em['pr_auc']:.4f}")
        if self.sparse_tables:
            params = self._materialize_tables(params, opt_state)
        self._sync()
        end = time.perf_counter()
        if timed_examples > 0:
            rate = timed_examples / max(end - t_steady, 1e-9)
        else:
            rate = n * epochs / max(end - t0, 1e-9)

        eval_metrics = None
        if test is not None:
            eval_metrics = self.evaluate(params, test, batch_size)
            if verbose:
                print("test: " + " ".join(f"{k}={v:.4f}" for k, v in eval_metrics.items()))
        return TrainResult(params=params, history=history, eval_metrics=eval_metrics,
                           examples_per_sec=rate, opt_state=opt_state)

    # ------------------------------------------------------------------
    def predict(self, params, ds: EncodedDataset, batch_size: Optional[int] = None) -> np.ndarray:
        """Probabilities [N] in the dataset's order (float32 numpy)."""
        if batch_size is None:
            batch_size = max(self.config.batch_size, 4096)
        params = {k: v.to(self.device) for k, v in params.items()}
        out = []
        with torch.no_grad():
            for feats, _, mask in ds.batches(batch_size, shuffle=False, pad_final=True):
                f = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                     for k, v in feats.items()}
                y = self._forward(params, f)
                p = torch.sigmoid(y[0] if isinstance(y, tuple) else y).cpu().numpy()
                if mask is not None:
                    p = p[mask > 0]
                out.append(p)
        return np.concatenate(out) if out else np.empty(0, np.float32)

    def evaluate(self, params, ds: EncodedDataset,
                 batch_size: Optional[int] = None) -> Dict[str, float]:
        """Exact (sort-based) eval metrics + mean BCE, like Keras `evaluate`."""
        probs = self.predict(params, ds, batch_size)
        labels = ds.labels[: len(probs)]
        eps = 1e-7
        p = np.clip(probs, eps, 1 - eps)
        bce = -(labels * np.log(p) + (1 - labels) * np.log(1 - p)).mean()
        acc = float(((probs > 0.5) == (labels > 0.5)).mean())
        return {"loss": float(bce), "accuracy": acc, **M.exact_auc(probs, labels)}

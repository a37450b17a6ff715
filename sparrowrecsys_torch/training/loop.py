"""The training loop: the port of `sparrowrecsys_tpu/training/loop.py`.

Replaces the reference's Keras `compile(loss='binary_crossentropy',
optimizer='adam', metrics=[accuracy, ROC-AUC, PR-AUC]); fit(...)` with:

- one train step: forward + BCE + group-fused Adam (`training/optim.py`)
  + streaming metrics kept on the device (`ops/metrics.py`);
- the epoch's rows in a given order, padded with dataset row 0 to whole
  batches and masked, as the JAX package's resident epoch does
  (`loop.py:255-265`): the padded rows' ids still count as touched rows of
  a sparse table, so their lazy-Adam moments decay. `shuffle_mode=
  "blocks"` permutes blocks of `shuffle_block` rows of the epoch padded
  with zero rows instead (`loop.py:219-252`);
- `sparse_tables`: the named embedding tables leave the dense optimizer
  and live in a fused [V, 3D] row-Adam buffer (`training/row_optim.py`);
  the step differentiates the buffer's table view and updates only the
  touched rows, through the row kernels on the card (the span
  `trainer.row_adam`, inside `trainer.optimizer`). A model built on the
  meta device stays there, for tables too large to hold twice;
- `bf16_table_params`: the big leaves stored in bfloat16 with float32
  masters in the optimizer state; `big_moment_dtype` narrows the big
  leaves' moments (`training/optim.py`);
- `fit(state_dir=, checkpoint_every=, resume=)`: the whole train state
  (params, optimizer state, the next epoch) checkpointed in the JAX
  package's format (`training/checkpoint.py`), so a run resumes from a
  state either package wrote. The order of epoch e depends on e alone,
  so a resumed run takes the batches the uninterrupted run takes.

Parameters are a dict of tensors keyed by `state_dict` name, applied with
`torch.func.functional_call`; `checkpoint.params_to_flax` turns one into
the JAX package's tree. A `loss_fn` (DIEN's `dien_loss_fn`) takes the
JAX protocol (`loop.py:76-82`, `:350-363`):
`loss_fn(forward, params, feats, labels, mask[, generator])` ->
(loss, (logits, summed masked objective)), with a per-step
`torch.Generator` when `loss_fn.wants_rng`.

`Trainer(plan=)` trains over a (data, model) mesh (`parallel/mesh.py`),
one process per rank, equal to single-device training up to the order
of float additions:
- every rank holds the whole dataset and takes its data coordinate's
  slice of each global batch, in the single-device order (`orders=`
  too); a `wants_rng` loss's draws are made for the global batch
  (`loss_fn.draw`) and sliced;
- the loss is normalised globally: the gradient of loss_sum / (the mask
  count summed over `data`), then the gradients summed over `data`, so a
  padded last batch whose shards hold different counts weighs as it does
  on one device; the metric state is summed over `data` before the AUC;
- tables row-sharded by the name rule (by their whole shapes,
  `min_rows_to_shard`) are looked up through `ops.embedding.
  sharded_lookup`; the optimizer's small-leaf split, the bfloat16
  moments and the narrowed tables follow the whole sizes; a sparse
  table's lazy row-Adam takes the global batch's ids (gathered over
  `data`) and updates only the rows this shard owns, in its local fused
  buffer, through the same row kernels;
- train states are gathered to rank 0 and written in the single-device
  layout; a resume shards them again. `fit` returns the whole params on
  every rank (and this rank's optimizer state).
A 1x1 plan runs the same arithmetic as no plan, bit for bit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import profiler as _profiler
from torch.func import functional_call

from sparrowrecsys_torch.config import TrainConfig
from sparrowrecsys_torch.data.dataset import EncodedDataset
from sparrowrecsys_torch.models.features import flax_init
from sparrowrecsys_torch.ops import metrics as M
from sparrowrecsys_torch.ops.embedding import RowShard, row_sharded
from sparrowrecsys_torch.parallel.collectives import WORLD
from sparrowrecsys_torch.parallel.mesh import (
    MIN_ROWS_TO_SHARD,
    gather_params,
    param_shardings,
    row_block,
    shard_params,
)
from sparrowrecsys_torch.training import checkpoint as ckpt
from sparrowrecsys_torch.training.optim import (
    SMALL_LEAF_MAX_ELEMS,
    GroupedAdamState,
    grouped_adam,
    split_leaves,
)
from sparrowrecsys_torch.training.row_optim import (
    FusedRowAdamState,
    fused_row_adam_update_many,
    fused_table,
    init_fused_row_adam,
)
from sparrowrecsys_torch.training.step_graph import StepGraph, leaves
from sparrowrecsys_torch.utils.device import resolve_device
from sparrowrecsys_torch.utils.profiling import span


@dataclasses.dataclass
class TrainResult:
    params: Dict[str, torch.Tensor]
    history: list  # per-epoch dicts of train metrics
    eval_metrics: Optional[Dict[str, float]] = None
    examples_per_sec: float = 0.0
    #: the optimizer state after the last step (with `sparse_tables`, its
    #: "rows" hold the fused [V, 3D] row-Adam buffers).
    opt_state: Any = None


def hard_sync(tree) -> None:
    """Wait for the work that produces `tree` (a tensor, or a dict, list
    or tuple of them, nested): one element of its first non-empty leaf is
    read back to the host, which completes only after the work queued
    before it on the leaf's stream. JAX: `training/loop.py::hard_sync`."""
    leaf = next((t for t in leaves(tree) if t.numel()), None)
    if leaf is not None:
        leaf.reshape(-1)[:1].cpu()


def _default_loss(logits, labels, mask):
    """Masked mean binary cross-entropy on logits (optax's
    `sigmoid_binary_cross_entropy`); returns (loss, summed masked BCE)."""
    bce = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
    loss_sum = (bce * mask).sum()
    return loss_sum / mask.sum().clamp_min(1.0), loss_sum


def _as_tensor(v) -> torch.Tensor:
    """A column as a tensor: a tensor as it is, a numpy array shared."""
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))


def _nbytes(v) -> int:
    return v.numel() * v.element_size() if isinstance(v, torch.Tensor) else v.nbytes


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one: a CUDA device without an index (the
    trainer's default `cuda`) is the current card, which a tensor's own
    device always names (`cuda:0`)."""
    def index(d):
        return torch.cuda.current_device() if d.type == "cuda" and d.index is None else d.index

    return a.type == b.type and index(a) == index(b)


def _moment_dtype(name: str) -> Optional[torch.dtype]:
    """TrainConfig.big_moment_dtype -> the torch dtype grouped_adam stores
    the big leaves' moments in (None for float32)."""
    if name == "float32":
        return None
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"big_moment_dtype={name!r} is not a floating torch dtype")
    return dtype


#: Eager steps a trainer runs on the card, on the capture's stream, before
#: it captures its step as a CUDA graph (PyTorch's guidance for capture):
#: lazy set-up, such as cuBLAS's handles and workspaces for that stream and
#: the cached metric thresholds, happens outside the capture.
GRAPH_WARMUP_STEPS = 3


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
        self.plan = plan
        #: Under a plan: tables of at least this many rows are row-sharded.
        self.min_rows_to_shard = MIN_ROWS_TO_SHARD
        self._shardings: Dict[str, tuple] = {}
        self._whole_shapes: Dict[str, tuple] = {}
        self.loss_fn = loss_fn
        self.config = config or TrainConfig()
        self.device = resolve_device(device)
        # A model built on the meta device (tables too large to hold twice)
        # stays there: its parameters are shapes, and each step passes its own.
        on_meta = all(p.is_meta for p in model.parameters())
        self.model = model if on_meta else model.to(self.device)
        #: {param module name: (feature columns gathering from it, ...)},
        #: e.g. {"emb_userId": ("userId",)}: those tables take the lazy
        #: row-Adam (untouched rows' moments freeze rather than decay).
        self.sparse_tables = {
            k: tuple(v) if not isinstance(v, str) else (v,)
            for k, v in (sparse_tables or {}).items()
        }
        self._table_keys = {f"{mod}.table" for mod in self.sparse_tables}
        cfg = self.config
        if cfg.bf16_table_params and self.sparse_tables:
            # The JAX package narrows the sparse tables too and then runs
            # the lazy row-Adam on a bfloat16 [V, 3D] buffer with narrow
            # moments and no master (ADVICE.md on `training/loop.py:181`).
            raise ValueError(
                "bf16_table_params with sparse_tables: the lazy row-Adam "
                "keeps no float32 master, so the tables would train in bfloat16")
        self.tx = grouped_adam(cfg.learning_rate, b1=cfg.adam_b1, b2=cfg.adam_b2,
                               eps=cfg.adam_eps,
                               big_moment_dtype=_moment_dtype(cfg.big_moment_dtype),
                               master_weights=cfg.bf16_table_params)
        #: Datasets at most this large are uploaded to the device once per
        #: fit; larger ones upload each batch.
        self.device_resident_bytes = 2 << 30
        #: The captured step (`_train_step`), the eager steps that may warm
        #: it up since the last one was dropped, and the capture's stream.
        self._graph: Optional[StepGraph] = None
        self._warm = 0
        self._capture_stream = None
        self._step_counts = {"eager": 0, "captured": 0, "replayed": 0}

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
        for the JAX signature; the shapes come from the model. Under
        `bf16_table_params` the float32 leaves of at least
        SMALL_LEAF_MAX_ELEMS elements are stored in bfloat16. The params
        are whole under a plan too; `fit` and `prepare` shard them."""
        seed = self.config.seed if seed is None else seed
        params = flax_init(self.model, torch.Generator().manual_seed(seed), self.device)
        if self.config.bf16_table_params:
            params = {k: v.bfloat16() if v.dtype == torch.float32
                      and v.numel() >= SMALL_LEAF_MAX_ELEMS else v
                      for k, v in params.items()}
        return params

    def prepare(self, params: Dict[str, torch.Tensor]):
        """(params in the fit form, a fresh optimizer state) from whole
        params, copied onto the device. Under a plan the params are this
        rank's shards (`parallel/mesh.py`'s rule on the whole shapes) and
        the optimizer splits its leaves by their whole sizes. With sparse
        tables the params hold placeholders (`_dense_view`), and each table
        is copied once, into its row-Adam buffer."""
        params = {k: v.to(self.device) if k in self._table_keys and self.plan is None
                  else v.to(self.device).clone() for k, v in params.items()}
        if self.plan is not None:
            self._shardings = param_shardings(params, self.plan, self.min_rows_to_shard)
            self._whole_shapes = {k: tuple(v.shape) for k, v in params.items()}
            self.tx.leaf_sizes = {k: v.numel() for k, v in self._dense_view(params).items()}
            params = {k: v.clone() for k, v in
                      shard_params(params, self.plan, shardings=self._shardings).items()}
        opt_state = self.init_opt_state(params)
        if self.sparse_tables:
            params = self._dense_view(params)
        return params, opt_state

    def _sharded(self, name: str) -> bool:
        return bool(self._shardings.get(name))

    def _map_state(self, params, opt_state, fn):
        """(params, opt_state) with `fn(name, leaf)` applied to each
        row-sharded leaf: the params (fit form), the dense optimizer's
        moments (the pieces of its fused small-leaf vector, the big-leaf
        lists) and masters, and the sparse tables' row buffers."""
        out = {k: fn(k, v) if self._sharded(k) and k not in self._table_keys else v
               for k, v in params.items()}
        dense = opt_state["dense"] if self.sparse_tables else opt_state
        small, big = split_leaves(params, self.tx.small_max_elems, self.tx.leaf_sizes)

        def vec(v):
            if not small:
                return v
            pieces = v.split([params[k].numel() for k in small])
            return torch.cat([fn(k, p.view(params[k].shape)).reshape(-1)
                              if self._sharded(k) and k not in self._table_keys else p
                              for k, p in zip(small, pieces)])

        def per_leaf(values):
            return [fn(k, x) if x is not None and self._sharded(k) else x
                    for k, x in zip(big, values)]

        dense = GroupedAdamState(
            dense.count, vec(dense.mu_vec), vec(dense.nu_vec), per_leaf(dense.mu_big),
            per_leaf(dense.nu_big),
            per_leaf(dense.master_big) if isinstance(dense.master_big, list) else dense.master_big)
        if not self.sparse_tables:
            return out, dense
        rows = {mod: FusedRowAdamState(st.count, fn(f"{mod}.table", st.buf)
                                       if self._sharded(f"{mod}.table") else st.buf)
                for mod, st in opt_state["rows"].items()}
        return out, {"dense": dense, "rows": rows}

    def gather_state(self, params, opt_state):
        """This rank's (params, opt_state) -> the whole ones, on every rank."""
        return self._map_state(params, opt_state,
                               lambda k, t: self.plan.all_gather(t, self.plan.model_axis))

    def shard_state(self, params, opt_state):
        """Whole (params, opt_state) -> this rank's shards (copies)."""
        def take(k, t):
            block = row_block(t.shape[0], self.plan)
            lo = self.plan.model_index * block
            return t[lo:lo + block].clone()

        return self._map_state(params, opt_state, take)

    def whole_params(self, params, opt_state) -> Dict[str, torch.Tensor]:
        """The trained params, whole on every rank: the sparse tables out of
        their buffers and, under a plan, the row-sharded leaves gathered."""
        if self.sparse_tables:
            params = self._materialize_tables(params, opt_state)
        if self.plan is not None:
            params = gather_params(params, self.plan, self._shardings)
        return params

    def _row_blocks(self, leaves) -> Dict[torch.Tensor, RowShard]:
        """The leaves whose lookups go through `sharded_lookup`: the
        row-sharded ones, when the model axis splits them."""
        if self.plan is None or self.plan.n_model == 1:
            return {}
        return {leaves[k]: RowShard(self.plan, self._whole_shapes[k][0])
                for k in leaves if self._sharded(k)}

    def _sum_over_data(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each tensor summed over the data axis, in one collective per dtype
        and kind. A replicated one (every name but a row-sharded leaf's)
        under a model axis is the sum of model rank 0's, taken over every
        rank, so that it is the same on each rank bit for bit whatever
        order the card's kernels add in: its replicas stay one value, as
        in the JAX package."""
        plan = self.plan
        if plan.comm is None:
            return tensors
        out = {}
        groups: Dict[tuple, list] = {}
        for k, v in tensors.items():
            replicated = plan.n_model > 1 and not self._sharded(k)
            groups.setdefault((v.dtype, replicated), []).append(k)
        for (_, replicated), names in groups.items():
            flat = torch.cat([tensors[k].reshape(-1) for k in names])
            if replicated and plan.model_index != 0:
                flat.zero_()
            plan.all_reduce(flat, WORLD if replicated else plan.data_axis)
            for k, piece in zip(names, flat.split([tensors[k].numel() for k in names])):
                out[k] = piece.view(tensors[k].shape)
        return {k: out[k] for k in tensors}

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
        its dense [V, D] gradient). Under a plan the batch is this rank's
        shard, the loss is normalised by the mask count over `data`, and
        the gradients come out summed over `data`."""
        leaves = self._diff_leaves(params, opt_state)
        with span("trainer.forward"):
            with row_sharded(self._row_blocks(leaves)):
                loss, logits, loss_sum = self._loss(leaves, feats, labels, mask, generator)
            if self.plan is not None:
                count = self.plan.all_reduce(mask.sum(), self.plan.data_axis)
                loss = loss_sum / count.clamp_min(1.0)
        with span("trainer.backward"):
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            if self.plan is not None:
                grads = self._sum_over_data(grads)
        return logits.detach(), loss.detach(), loss_sum.detach(), grads

    @torch.no_grad()
    def apply_grads(self, params, opt_state, grads, feats):
        """The optimizer step: group-fused Adam on the dense params (in
        place) and the lazy row-Adam on each sparse table's touched rows
        (in place in its buffer). Returns (params, opt_state)."""
        cfg = self.config
        with span("trainer.optimizer"):
            if self.sparse_tables:
                # The placeholders' (empty) gradients ride along, in the
                # order the dense state was initialised with.
                gdense = {k: v if k in self._table_keys else grads[k] for k, v in params.items()}
                updates, dstate = self.tx.update(gdense, opt_state["dense"], params)
                with span("trainer.row_adam"):
                    ids = []
                    for mod, cols in self.sparse_tables.items():
                        got = [feats[c].reshape(-1).to(torch.int32) for c in cols]
                        got = got[0] if len(got) == 1 else torch.cat(got)
                        if self.plan is not None:
                            # The global batch's ids; a shard's own rows by local id.
                            got = self.plan.all_gather(got, self.plan.data_axis)
                            if self._sharded(f"{mod}.table"):
                                got = got - (self.plan.model_index
                                             * opt_state["rows"][mod].buf.shape[0])
                        ids.append(got)
                    rows = dict(zip(self.sparse_tables, fused_row_adam_update_many(
                        [opt_state["rows"][mod] for mod in self.sparse_tables],
                        [grads[f"{mod}.table"] for mod in self.sparse_tables], ids,
                        learning_rate=cfg.learning_rate, b1=cfg.adam_b1,
                        b2=cfg.adam_b2, eps=cfg.adam_eps)))
                opt_state = {"dense": dstate, "rows": rows}
            else:
                updates, opt_state = self.tx.update(grads, opt_state, params)
            for k, v in params.items():
                if k not in self._table_keys:
                    v.add_(updates[k])
            return params, opt_state

    def _step(self, params, opt_state, mstate, feats, labels, mask, generator=None):
        """The step launched op by op: updates `params` (and sparse buffers)
        in place and returns (params, opt_state, mstate)."""
        with span("trainer.step"):
            logits, _, loss_sum, grads = self.loss_and_grads(
                params, opt_state, feats, labels, mask, generator)
            params, opt_state = self.apply_grads(params, opt_state, grads, feats)
            mstate = M.update_metrics(mstate, torch.sigmoid(logits), labels, loss_sum, mask)
        return params, opt_state, mstate

    def _train_step(self, params, opt_state, mstate, feats, labels, mask, generator=None):
        """One step; updates `params` (and sparse buffers) in place and
        returns (params, opt_state, mstate).

        On the card the step is captured once as a CUDA graph and replayed
        (`training/step_graph.py`) where it can be: no plan, no sparse
        tables, no per-step `generator`, no `torch.profiler` recording (a
        traced step runs eagerly, so its spans and kernels are seen), and a
        batch of the captured keys, shapes and dtypes on the params and
        optimizer state the graph holds. GRAPH_WARMUP_STEPS such steps run
        eagerly first, on the stream the graph is captured on; the next one
        captures the graph and replays it once. Any other step runs eagerly.
        One on the graph's params and state copies its new states into the
        graph's tensors, so the graph stays; one on other params or state
        drops the graph, which is warmed up and captured again for the new
        state. Once a graph holds them, the optimizer and metric states a
        step returns are the graph's tensors, which the next step overwrites
        in place. `step_counts()` counts the three kinds of step."""
        graph = self._graph
        if graph is not None and not graph.holds(params, opt_state):
            graph = self._graph = None
            self._warm = 0
        if self._graphable(generator):
            if graph is not None and graph.fits(feats, labels, mask):
                self._step_counts["replayed"] += 1
                return graph.replay(feats, labels, mask, mstate)
            if graph is None and self._warm == GRAPH_WARMUP_STEPS:
                graph = self._graph = StepGraph(self._step, params, opt_state, mstate, feats,
                                                labels, mask, self._capture_stream)
                self._step_counts["captured"] += 1
                return graph.replay(feats, labels, mask, mstate)
            if graph is None:
                self._warm += 1
                self._step_counts["eager"] += 1
                return self._step_on_capture_stream(params, opt_state, mstate, feats, labels, mask)
        self._step_counts["eager"] += 1
        out = self._step(params, opt_state, mstate, feats, labels, mask, generator)
        return out if graph is None else graph.keep(*out)

    def _graphable(self, generator) -> bool:
        """Whether a step may run as the captured graph, by what it can see."""
        return (self.device.type == "cuda" and self.plan is None and not self.sparse_tables
                and generator is None and not _profiler._is_profiler_enabled)

    def _step_on_capture_stream(self, *args):
        """A warm-up step, on the stream the graph is captured on. Each
        warm-up step runs there, not only the last: the caching allocator
        keeps its blocks by stream, and a step on a second stream would
        allocate them all a second time."""
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        here = torch.cuda.current_stream(self.device)
        self._capture_stream.wait_stream(here)
        with torch.cuda.stream(self._capture_stream):
            out = self._step(*args)
        here.wait_stream(self._capture_stream)
        return out

    def step_counts(self) -> Dict[str, int]:
        """{"eager", "captured", "replayed"}: this trainer's `_train_step`
        calls by how they ran. A kernel's `launches` counter counts host
        calls, so it counts the eager and captured steps and not the
        replayed ones."""
        return dict(self._step_counts)

    # ------------------------------------------------------------------
    def _use_blocks(self, padded: int) -> bool:
        """Whether the epoch is shuffled by blocks: `shuffle_mode="blocks"`,
        a shuffled run, and a padded epoch of whole blocks. Otherwise the
        exact shuffle (`loop.py:232-236`)."""
        cfg = self.config
        return (cfg.shuffle_each_epoch and cfg.shuffle_mode == "blocks"
                and padded % cfg.shuffle_block == 0)

    def _epoch_order(self, n: int, padded: int, epoch: int, orders) -> tuple:
        """(row order [padded] int64, valid mask [padded] float32) on the
        device, for epoch `epoch` alone.

        Exact: `orders[epoch]` (n row indices) when given, else a
        permutation from a generator seeded with seed + epoch (arange
        without shuffle), its tail padded with row 0 (`loop.py:255-265`).
        Blocks: the epoch padded with zero rows to `padded` is cut into
        blocks of `shuffle_block` rows, which move in the order
        `orders[epoch]` (the JAX package's
        `jax.random.permutation(PRNGKey(seed + epoch), padded // block)`)
        or a permutation from the generator; the pad rows are row n of
        the columns (a zero row, see `_columns`), and the mask moves with
        them (`loop.py:238-253`)."""
        cfg = self.config
        gen = torch.Generator().manual_seed(cfg.seed + epoch)
        if self._use_blocks(padded):
            block = cfg.shuffle_block
            nb = padded // block
            if orders is not None:
                border = torch.from_numpy(np.array(orders[epoch], dtype=np.int64))
                if border.shape != (nb,):
                    raise ValueError(f"orders[{epoch}] has shape {tuple(border.shape)}, "
                                     f"want the block order ({nb},)")
            else:
                border = torch.randperm(nb, generator=gen)
            pos = (border[:, None] * block + torch.arange(block)).reshape(-1)
            valid = pos < n
            return torch.where(valid, pos, n).to(self.device), valid.float().to(self.device)
        if orders is not None:
            order = torch.from_numpy(np.array(orders[epoch], dtype=np.int64))
            if order.shape != (n,):
                raise ValueError(f"orders[{epoch}] has shape {tuple(order.shape)}, want ({n},)")
        elif cfg.shuffle_each_epoch:
            order = torch.randperm(n, generator=gen)
        else:
            order = torch.arange(n)
        order = torch.cat([order, torch.zeros(padded - n, dtype=torch.int64)])
        valid = torch.arange(padded) < n
        return order.to(self.device), valid.float().to(self.device)

    def _columns(self, ds: EncodedDataset, zero_row: bool = False):
        """The dataset's columns and labels as tensors: on the device when
        they fit `device_resident_bytes` or already live there (the
        columns of `data.device_pipeline.encode_samples_device`, taken as
        they are), else on the host. `zero_row` appends one all-zero row
        (row n: the block shuffle's pad row), on the columns' device."""
        arrays = [*ds.features.values(), ds.labels]
        nbytes = sum(_nbytes(v) for v in arrays)
        resident = all(isinstance(v, torch.Tensor) and _same_device(v.device, self.device)
                       for v in arrays)
        dev = (self.device if resident or nbytes <= self.device_resident_bytes
               else torch.device("cpu"))

        def tensor(v):
            t = _as_tensor(v).to(dev)
            if zero_row:
                t = torch.cat([t, t.new_zeros((1,) + t.shape[1:])])
            return t

        return {k: tensor(v) for k, v in ds.features.items()}, tensor(ds.labels)

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
        checkpoint_every: int = 1,
        resume: bool = False,
        orders: Optional[Sequence[Any]] = None,
    ) -> TrainResult:
        """Train; returns a TrainResult with the steady-state examples/s
        (the epochs after the first this call runs, or all of them when it
        runs one).

        `state_dir`: the whole train state (params, optimizer state, the
        next epoch) is saved there after every `checkpoint_every` epochs
        and after the last (`checkpoint.save_train_state`; keeps
        `TrainConfig.checkpoint_keep` versions). `resume=True` restores
        the newest state there and continues at its epoch; with no
        version there at all it starts cold, and a params-only export
        raises `checkpoint.NotATrainStateError`.

        `orders`: an optional order per epoch (`orders[epoch]`: n row
        indices, or under the block shuffle the block order), e.g. the
        JAX package's `jax.random.permutation(PRNGKey(seed + epoch), n)`;
        without it the order comes from a torch.Generator seeded with
        seed + epoch. Either way epoch e's order depends on e alone, so a
        resumed run replays the uninterrupted run's batches.
        The caller's `params` (whole, under a plan too) are copied, not
        changed; their dtypes stay."""
        cfg = self.config
        epochs = cfg.epochs if epochs is None else epochs
        batch_size = cfg.batch_size if batch_size is None else batch_size
        plan = self.plan
        if params is None:
            params = self.init_params(train.features)
        whole = params
        params, opt_state = self.prepare(params)
        start_epoch = 0
        if resume and state_dir:
            try:
                if plan is None:
                    params, opt_state, start_epoch, _ = ckpt.load_latest_train_state(
                        state_dir, self.model, params, opt_state)
                else:
                    # Whole templates (the single-device layout), then shards.
                    tparams = {k: v.to(self.device) for k, v in whole.items()}
                    topt = self.init_opt_state(tparams)
                    if self.sparse_tables:
                        tparams = self._dense_view(tparams)
                    wparams, wopt, start_epoch, _ = ckpt.load_latest_train_state(
                        state_dir, self.model, tparams, topt)
                    params, opt_state = self.shard_state(wparams, wopt)
                if verbose:
                    print(f"resumed train state at epoch {start_epoch}")
            except FileNotFoundError:
                pass  # no version at all: a cold start

        n = len(train)
        steps = -(-n // batch_size)
        padded = steps * batch_size
        per, lo = batch_size, 0
        if plan is not None:
            if batch_size % plan.n_data:
                raise ValueError(f"batch_size {batch_size} does not split over "
                                 f"{plan.n_data} data ranks")
            per = batch_size // plan.n_data
            lo = plan.data_index * per
        draw = getattr(self.loss_fn, "draw", None)
        if cfg.shuffle_mode == "blocks" and padded % cfg.shuffle_block != 0:
            print(f"shuffle_mode='blocks' requested but padded epoch size {padded} "
                  f"is not a multiple of shuffle_block={cfg.shuffle_block}; "
                  "falling back to exact shuffle")
        cols, labels_all = self._columns(train, zero_row=self._use_blocks(padded))
        wants_rng = bool(getattr(self.loss_fn, "wants_rng", False))
        history = []
        timed_examples = 0
        t0 = time.perf_counter()
        t_steady = None
        for epoch in range(start_epoch, epochs):
            mstate = M.init_metrics(self.device)
            order, valid = self._epoch_order(n, padded, epoch, orders)
            for s in range(steps):
                # This rank's rows of global batch s (all of it on one device).
                sl = slice(s * batch_size + lo, s * batch_size + lo + per)
                feats, labels = self._gather(cols, labels_all, order[sl])
                gen = self.step_generator(epoch, s) if wants_rng else None
                if gen is not None and plan is not None:
                    if draw is None:
                        raise NotImplementedError(
                            "a wants_rng loss under a plan needs loss_fn.draw to make "
                            "the global batch's draws")
                    glob = slice(s * batch_size, (s + 1) * batch_size)
                    gfeats = draw(gen, self._gather(cols, labels_all, order[glob])[0])
                    feats, gen = {k: v[lo:lo + per] for k, v in gfeats.items()}, None
                params, opt_state, mstate = self._train_step(
                    params, opt_state, mstate, feats, labels, valid[sl], gen)
            if plan is not None:
                mstate = self._metrics_over_data(mstate)
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
            done = epoch + 1
            if state_dir and (done == epochs or (checkpoint_every and done % checkpoint_every == 0)):
                self._save_state(params, opt_state, done, state_dir)
        params = self.whole_params(params, opt_state)
        self._sync()
        end = time.perf_counter()
        if timed_examples > 0:
            rate = timed_examples / max(end - t_steady, 1e-9)
        else:
            rate = n * len(history) / max(end - t0, 1e-9)

        eval_metrics = None
        if test is not None:
            eval_metrics = self.evaluate(params, test, batch_size)
            if verbose:
                print("test: " + " ".join(f"{k}={v:.4f}" for k, v in eval_metrics.items()))
        return TrainResult(params=params, history=history, eval_metrics=eval_metrics,
                           examples_per_sec=rate, opt_state=opt_state)

    def _metrics_over_data(self, mstate: M.MetricState) -> M.MetricState:
        """The metric state summed over `data` (one collective)."""
        parts = self._sum_over_data(dict(zip(M.MetricState._fields, mstate)))
        return M.MetricState(**parts)

    def _save_state(self, params, opt_state, next_epoch: int, state_dir: str) -> None:
        """`checkpoint.save_train_state`; under a plan the whole state,
        gathered and written by rank 0 while the others wait."""
        if self.plan is not None:
            params, opt_state = self.gather_state(params, opt_state)
            if self.plan.rank != 0:
                self.plan.barrier()
                return
        ckpt.save_train_state(self.model, params, opt_state, next_epoch, state_dir,
                              keep=self.config.checkpoint_keep)
        if self.plan is not None:
            self.plan.barrier()

    # ------------------------------------------------------------------
    def predict(self, params, ds: EncodedDataset, batch_size: Optional[int] = None) -> np.ndarray:
        """Probabilities [N] in the dataset's order (float32 numpy)."""
        if batch_size is None:
            batch_size = max(self.config.batch_size, 4096)
        params = {k: v.to(self.device) for k, v in params.items()}
        out = []
        with torch.no_grad():
            for feats, _, mask in ds.batches(batch_size, shuffle=False, pad_final=True):
                f = {k: _as_tensor(v).to(self.device) for k, v in feats.items()}
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
        labels = _as_tensor(ds.labels[: len(probs)]).cpu().numpy()
        eps = 1e-7
        p = np.clip(probs, eps, 1 - eps)
        bce = -(labels * np.log(p) + (1 - labels) * np.log(1 - p)).mean()
        acc = float(((probs > 0.5) == (labels > 0.5)).mean())
        return {"loss": float(bce), "accuracy": acc, **M.exact_auc(probs, labels)}

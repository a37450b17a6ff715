"""DLRM-DCNv2's training steps: `Trainer._train_step` on the program's
`dlrm_dcnv2` model, one after another on columns made on the card from the
seed, with the checked steps, window and trace of `train_steps`. The
configuration gives the widths, the tables' rows and each feature's ids
an example; the traffic the batch, the ids' skew and the share of
positive labels.

The model is built on the meta device (its parameters are shapes alone).
The configuration says which tables train with lazy Adam: those whose
float32 rows take more than `lazy_adam_table_bytes` (`sparse_names`).
They go to `Trainer(sparse_tables=)`, the lazy row-Adam over a [V, 3D]
buffer a table, and the reference takes the same set. A program whose
model names another set (`sparse_tables()`) fails before it trains. The
weights are made on the card, handed to `Trainer.prepare`, and the
tables' own copies dropped.

At set-up, from the cycled batches and outside the window: each sparse
table's distinct rows a batch (the row-Adam's least work, which
`row_adam_roofline.train` reads), and the rows the checked steps touch,
with their first values. The checked steps' readings: each step's loss;
each dense leaf's first gradient (Adam's first moment after step 1 over
1 - b1) and its change after the last step; for each sparse table the
same two over the rows the checked steps touch. The notes give the row
kernels' and the small-table backward's launches over the checked steps
(`kernels.launch_counters()`).

After the window the program's state is freed and the reference
(`reference/dlrm_dcnv2.py`) repeats the checked steps from the same
weights and batches, made again from the seed; of each sparse table it
holds only the rows the checked steps touch, with the ids remapped onto
them (rows no step touches do not change under lazy Adam).

A program without the `dlrm_dcnv2` model fails at once (`model_on_meta`),
before it builds anything.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from benchmark import costs_dlrm, harness, weights_dlrm
from benchmark.drivers import train_steps
from benchmark.reference import dlrm_dcnv2 as ref
from benchmark.trace import Profiled

#: The program's kernels whose launches over the checked steps the notes
#: give (`kernels.launch_counters()`).
KERNELS = ("rows_gather", "rows_write", "embedding_bwd")


def model_args(cfg: dict) -> dict:
    return {"embedding_dim": cfg["embedding_dim"],
            "dense_sizes": cfg["dense_arch_layer_sizes"],
            "over_sizes": cfg["over_arch_layer_sizes"],
            "cross_layers": cfg["dcn_num_layers"], "cross_rank": cfg["dcn_low_rank_dim"],
            "table_rows": cfg["num_embeddings_per_feature"],
            "multi_hot": cfg["multi_hot_sizes"], "compute_dtype": cfg["compute_dtype"]}


def model_on_meta(cfg: dict):
    """The program's model at the configuration's widths, on the meta
    device; raises KeyError where the program has no `dlrm_dcnv2`."""
    from sparrowrecsys_torch.models import build_model

    with torch.device("meta"):
        return build_model("dlrm_dcnv2", **model_args(cfg))


def sparse_names(cfg: dict) -> List[str]:
    """The tables (`emb_cat_f.table`) that the configuration trains with
    lazy Adam: those of more than `lazy_adam_table_bytes` in float32."""
    d, most = cfg["embedding_dim"], cfg["lazy_adam_table_bytes"]
    return [k for k, rows in zip(weights_dlrm.table_names(cfg), cfg["num_embeddings_per_feature"])
            if rows * d * 4 > most]


def sparse_tables(cfg: dict, model) -> Dict[str, tuple]:
    """`Trainer(sparse_tables=)` for the configuration's lazy tables;
    raises ValueError where the program's model names another set."""
    want = {k[:-len(".table")]: (_column(k),) for k in sparse_names(cfg)}
    have = dict(model.sparse_tables())
    if have != want:
        raise ValueError(f"the program's lazy tables {sorted(have)} are not the "
                         f"configuration's {sorted(want)}")
    return want


def _column(name: str) -> str:
    return name[len("emb_"):-len(".table")]


def _launches() -> Dict[str, int]:
    from sparrowrecsys_torch.ops import kernels

    have = kernels.launch_counters() if hasattr(kernels, "launch_counters") else {}
    return {n: have[n].launches for n in KERNELS if n in have}


class Job(train_steps.Job):
    """`train_steps.Job` for DLRM-DCNv2: its trainer on the sparse tables,
    its columns, and the readings of its sparse tables."""

    def __init__(self, ctx: harness.Context):
        import sparrowrecsys_torch.ops.metrics as M
        from sparrowrecsys_torch.config import TrainConfig
        from sparrowrecsys_torch.training.loop import Trainer

        self.metrics = M
        cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
        batch, pool, opt = tr["batch"], train_steps.POOL_BATCHES, cfg["optimizer"]
        model = model_on_meta(cfg)
        self.trainer = Trainer(model, TrainConfig(batch_size=batch, epochs=1,
                                                  learning_rate=opt["learning_rate"],
                                                  adam_b1=opt["adam_b1"],
                                                  adam_b2=opt["adam_b2"],
                                                  adam_eps=opt["adam_eps"]),
                               device=dev, sparse_tables=sparse_tables(cfg, model))
        self.sparse = [f"{m}.table" for m in self.trainer.sparse_tables]
        self.dim = cfg["embedding_dim"]
        feats, labels = weights_dlrm.train_columns(cfg, tr, ctx.seed, dev, pool * batch)
        self.batches = [({k: v[i * batch:(i + 1) * batch] for k, v in feats.items()},
                         labels[i * batch:(i + 1) * batch]) for i in range(pool)]
        del feats, labels
        ctx.mark("columns_made")
        w0 = weights_dlrm.make_all(cfg, ctx.seed, dev)
        self.params, self.opt_state = self.trainer.prepare(w0)
        self.w0 = {k: v for k, v in w0.items() if k not in self.sparse}
        del w0
        # Each sparse table's distinct rows a batch, and the rows the
        # checked steps touch with their first values.
        self.distinct = [[int(torch.unique(b[_column(k)]).numel()) for k in self.sparse]
                         for b, _ in self.batches]
        self.ids = [[b[_column(k)].numel() for k in self.sparse] for b, _ in self.batches]
        checked = self.batches[:train_steps.CHECKED_STEPS]
        self.touched = {k: torch.unique(torch.cat([b[_column(k)].reshape(-1) for b, _ in checked]))
                        .long() for k in self.sparse}
        self.rows0 = {k: self._buf(k)[self.touched[k], :self.dim].clone() for k in self.sparse}
        self.mask = torch.ones(batch, device=dev)
        self.mstate = M.init_metrics(dev)
        self.n = 0
        ctx.mark("trainer_built")

    def _buf(self, name: str) -> torch.Tensor:
        return self.opt_state["rows"][name[:-len(".table")]].buf

    def _dense_moments(self) -> Dict[str, torch.Tensor]:
        from sparrowrecsys_torch.training.optim import split_leaves

        tx, params, dense = self.trainer.tx, self.params, self.opt_state["dense"]
        small, big = split_leaves(params, tx.small_max_elems, tx.leaf_sizes)
        out = dict(zip(small, dense.mu_vec.split([params[k].numel() for k in small])))
        out.update(zip(big, dense.mu_big))
        return {k: out[k] for k in self.w0}

    def checked_steps(self, n: int, b1: float) -> dict:
        """Run the first n steps; the program's readings of them."""
        losses = []
        real = self.trainer.loss_and_grads

        def keep_loss(*a, **k):
            out = real(*a, **k)
            losses.append(out[1])
            return out

        self.trainer.loss_and_grads = keep_loss
        prog: Dict[str, object] = {}
        d = self.dim
        try:
            for i in range(n):
                self.step()
                if i == 0:
                    mu = self._dense_moments()
                    grad1 = {k: float((m.double() / (1 - b1)).norm()) for k, m in mu.items()}
                    for k in self.sparse:
                        m = self._buf(k)[self.touched[k], d:2 * d]
                        grad1[k] = float((m.double() / (1 - b1)).norm())
                    prog["grad1"] = grad1
        finally:
            self.trainer.loss_and_grads = real
        change = {k: float((self.params[k].double() - w.double()).norm())
                  for k, w in self.w0.items()}
        for k in self.sparse:
            rows = self._buf(k)[self.touched[k], :d]
            change[k] = float((rows.double() - self.rows0[k].double()).norm())
        prog["change"] = change
        prog["loss"] = [float(x) for x in losses]
        self.w0 = self.rows0 = None
        return prog

    def row_adam_bytes(self, first: int, steps: int) -> float:
        """The row-Adam's least bytes a step, over steps first..first+steps-1
        (batch i % pool at step i)."""
        pool = len(self.batches)
        got = [costs_dlrm.row_adam_bytes(self.distinct[i % pool], self.ids[i % pool], self.dim)
               for i in range(first, first + steps)]
        return sum(got) / len(got)


def run(ctx: harness.Context) -> harness.Outcome:
    cfg, tr = ctx.config, ctx.traffic
    dev = ctx.device
    cuda = torch.device(dev).type == "cuda"
    model_on_meta(cfg)  # a program without the model fails here, before any work
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    job = Job(ctx)
    before = _launches()
    prog = job.checked_steps(train_steps.CHECKED_STEPS, cfg["optimizer"]["adam_b1"])
    after = _launches()
    ran = {k: after[k] - before[k] for k in after}
    ctx.mark("checked_steps")
    if ctx.trace:
        Profiled.warm(dev)

    steps = 0
    trace_steps = train_steps.TRACE_STEPS if ctx.trace else 0
    train_steps._sync(dev)
    t0 = time.monotonic()
    ctx.values["setup_s"] = t0 - ctx.t_start
    traced = False
    while True:
        now = time.monotonic()
        if trace_steps and not traced and now >= t0 + ctx.seconds / 2:
            train_steps._sync(dev)
            ctx.values["step_s"] = (time.monotonic() - t0) / max(steps, 1)
            ctx.values["row_adam_bytes"] = job.row_adam_bytes(job.n, trace_steps)
            with Profiled(dev) as prof:
                for _ in range(trace_steps):
                    job.step()
            ctx.device_trace = prof.trace
            steps += trace_steps
            traced = True
            continue
        if now >= t0 + ctx.seconds and (traced or not trace_steps):
            break
        job.step()
        steps += 1
    train_steps._sync(dev)
    window = time.monotonic() - t0
    final_loss = job.final_loss()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    batch = tr["batch"]
    ctx.values.update({
        "steps": steps, "window_s": window, "traced_steps": trace_steps,
        "flops_per_step": 3.0 * costs_dlrm.config_flops_per_example(cfg) * batch,
        "peak_flops": cfg["peak_flops_per_s"], "batch": batch,
    })
    distinct = {k: [job.distinct[i][j] for i in range(len(job.batches))]
                for j, k in enumerate(job.sparse)}
    sparse = job.sparse
    del job
    if cuda:
        torch.cuda.empty_cache()
    checks, got = compare(ctx, prog, sparse)
    return harness.Outcome(
        end_to_end={"train_examples_per_s": steps * batch / window,
                    "setup_s": ctx.values["setup_s"]},
        attempted=steps, failed=0 if final_loss == final_loss else steps,
        checks=checks, memory_peak_bytes=peak,
        notes={"window": {"steps": steps, "seconds": window, "final_loss": final_loss},
               "program_loss": prog["loss"], "checked_launches": ran,
               "sparse_tables": len(sparse), "distinct_rows_per_batch": distinct,
               "leaves": {k: got[k] for k in ("grad1_leaf", "change_leaf", "left_out",
                                              "table_grad1_leaf", "table_change_leaf")},
               **({"trace": ctx.device_trace.summary()} if ctx.device_trace else {})})


def reference_readings(ctx: harness.Context, sparse: List[str],
                       precision: str = "stated") -> dict:
    """The reference's readings of the checked steps, from the weights and
    batches made again from the seed; of each table in `sparse`, the rows
    the checked steps touch alone, the ids remapped onto them."""
    cfg, tr = ctx.config, ctx.traffic
    batch, checked = tr["batch"], train_steps.CHECKED_STEPS
    feats, labels = weights_dlrm.train_columns(cfg, tr, ctx.seed, ctx.device,
                                               train_steps.POOL_BATCHES * batch)
    batches = [({k: v[i * batch:(i + 1) * batch] for k, v in feats.items()},
                labels[i * batch:(i + 1) * batch]) for i in range(checked)]
    del feats, labels
    w = weights_dlrm.make_dense(cfg, ctx.seed, ctx.device)
    for f, k in enumerate(weights_dlrm.table_names(cfg)):
        table = weights_dlrm.make_table(cfg, ctx.seed, f, ctx.device)
        if k not in sparse:
            w[k] = table
            continue
        col = _column(k)
        rows = torch.unique(torch.cat([b[col].reshape(-1) for b, _ in batches])).long()
        w[k] = table[rows].clone()
        del table
        for b, _ in batches:
            b[col] = torch.searchsorted(rows, b[col].long())
    return ref.train_readings(w, batches, sparse, cfg["optimizer"], precision)


def output_leaf(names) -> str:
    """The over arch's output layer's weight (`top.<last>.weight`)."""
    tops = [k for k in names if k.startswith("top.") and k.endswith(".weight")]
    return max(tops, key=lambda k: int(k.split(".")[1]))


def gaps(prog: dict, refr: dict, sparse: List[str]) -> dict:
    """The compared numbers (and the leaf or table each widest gap was at):
    `train_steps.gaps` over the dense leaves; `out_grad1_gap`, the output
    layer's first gradient among them; `change_median_gap` beside
    `grad1_median_gap`; and the same two widest gaps over the sparse
    tables' touched rows (`table_grad1_gap`, `table_change_gap`), each
    table's against the larger of its own reference norm and the median
    table's.

    The output layer's first gradient is the sum over the batch of the
    loss's gradient in the logit times the last hidden layer's values: the
    forward's values alone, with no ReLU's derivative in it. Every other
    leaf's passes through ReLUs, where a pre-activation within round-off
    of zero (a few of the step's 30 M) may fall on either side in the
    program and in the reference, and move that leaf's gradient by one
    example's share."""
    dense = lambda d: {k: v for k, v in d.items() if k not in sparse}  # noqa: E731
    tables = lambda d: {k: d[k] for k in sparse}  # noqa: E731
    got = train_steps.gaps({**prog, "grad1": dense(prog["grad1"]),
                            "change": dense(prog["change"])},
                           {**refr, "grad1": dense(refr["grad1"]),
                            "change": dense(refr["change"])})
    keep = train_steps.ref.moved_leaves(dense(refr["grad1"]))
    out = output_leaf(keep)
    got["out_grad1_gap"] = got["grad1_by_leaf"][out]
    got["change_median_gap"] = train_steps.ref.median_gap(dense(prog["change"]),
                                                          dense(refr["change"]), keep)
    worst = train_steps.ref.worst_gap
    got["table_grad1_gap"], got["table_grad1_leaf"] = worst(
        tables(prog["grad1"]), tables(refr["grad1"]), sparse)
    got["table_change_gap"], got["table_change_leaf"] = worst(
        tables(prog["change"]), tables(refr["change"]), sparse)
    return got


def compare(ctx: harness.Context, prog: dict, sparse: List[str]):
    """(the checks, every reading of the comparison)."""
    got = gaps(prog, reference_readings(ctx, sparse), sparse)
    limits = harness.limits_of(ctx.root, ctx.cell["name"])
    return [harness.Check(k, v, limits[k]) for k, v in got.items() if k in limits], got

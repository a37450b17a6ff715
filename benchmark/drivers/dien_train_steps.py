"""DIEN's training steps: `Trainer._train_step` with `dien_loss_fn`, one
after another on columns made on the card from the seed, with the same
checked steps, window and trace as `train_steps` runs for DIN. The
traffic sets the batch, the history's length (the model's
`recent_movies`), the skew of the movie ids and the share of positive
labels; the negatives (one a history step after the first) are made
with the columns (`weights_dien.train_columns`).

With `--trace 1` the window's middle steps run under the profiler, with
a `bench.rnn_fwd` range around every call of the program's two
recurrences (`ops/augru.py::gru_recurrence` and `augru_recurrence`, the
steps after the input projections) and a `bench.rnn_bwd` range around
each one's backward. A program without those functions gets no ranges.

The cell measures DIEN with its recurrences as the program's one-launch
scans (`SCANS`). A program without them, whose recurrences are per-step
loops with O(T^2) bytes in their backward, cannot run the cell: the run
raises `CannotRun` before it builds anything. On the card the checked
steps must also have run every scan once a step at least.

After the window the program's state is freed and the reference
(`reference/dien.py`) repeats the checked steps from the same weights
and batches, made again from the seed; `gaps` compares the two.
"""

from __future__ import annotations

import time

import torch

from benchmark import costs_dien, harness, weights_dien
from benchmark.drivers import train_steps
from benchmark.reference import dien as ref
from benchmark.trace import Profiled

#: The program's recurrences that the ranges wrap.
RECURRENCES = ("gru_recurrence", "augru_recurrence")
#: The program's scan kernels (`kernels.launch_counters()`) that the cell
#: runs DIEN's recurrences on, forward and backward.
SCANS = ("gru_scan_fwd", "gru_scan_bwd", "augru_scan_fwd", "augru_scan_bwd")


class CannotRun(RuntimeError):
    """The program cannot run this cell: it has no scans, or its steps did
    not run them."""


def scan_counters() -> dict:
    """The program's scan kernels' wrappers by name, each carrying
    `launches`; raises `CannotRun` where the program lacks any of them."""
    from sparrowrecsys_torch.ops import kernels

    have = kernels.launch_counters() if hasattr(kernels, "launch_counters") else {}
    missing = [n for n in SCANS if n not in have]
    if missing:
        raise CannotRun(f"the program has no {', '.join(missing)}: this cell measures DIEN with "
                        "its recurrences as one-launch scans, not as per-step loops")
    return {n: have[n] for n in SCANS}


def scans_ran(scans: dict, before: dict, steps: int) -> dict:
    """Each scan's launches since `before`; raises `CannotRun` unless every
    one launched at least once in each of `steps` steps."""
    ran = {n: fn.launches - before[n] for n, fn in scans.items()}
    if min(ran.values()) < steps:
        raise CannotRun(f"{steps} steps launched the scans {ran} times: the recurrences ran off "
                        "the scans, which this cell measures")
    return ran


def build(ctx: harness.Context):
    """(trainer, params, opt_state, the weights by export name, names)."""
    from sparrowrecsys_torch.config import TrainConfig
    from sparrowrecsys_torch.models import build_model
    from sparrowrecsys_torch.models.dien import HEAD_WIDTH, dien_loss_fn
    from sparrowrecsys_torch.training.checkpoint import flax_layout
    from sparrowrecsys_torch.training.loop import Trainer

    cfg, opt, t = ctx.config, ctx.config["optimizer"], ctx.traffic["history"]
    if not cfg["gru_hidden"] == cfg["augru_hidden"] == cfg["dim"] or \
            not cfg["attention_hidden"] == cfg["aux_hidden"] == HEAD_WIDTH:
        raise ValueError("the program's DIEN has states of the embedding's width and heads of "
                         f"{HEAD_WIDTH}")
    model = build_model(cfg["model"], dim=cfg["dim"], movie_buckets=cfg["movie_buckets"],
                        user_buckets=cfg["user_buckets"], aux_mode=cfg["aux_mode"],
                        alpha=cfg["alpha"], hidden=cfg["hidden"],
                        compute_dtype=cfg["compute_dtype"], recent_movies=t)
    loss_fn = dien_loss_fn(alpha=cfg["alpha"], aux_mode=cfg["aux_mode"], recent_movies=t,
                           movie_vocab=cfg["movie_buckets"])
    trainer = Trainer(model, TrainConfig(batch_size=ctx.traffic["batch"], epochs=1,
                                         learning_rate=opt["learning_rate"],
                                         adam_b1=opt["adam_b1"], adam_b2=opt["adam_b2"],
                                         adam_eps=opt["adam_eps"]),
                      loss_fn=loss_fn, device=ctx.device)
    w0 = weights_dien.make_dien(cfg, ctx.seed, ctx.device)
    names = {key: ("/".join(path), transpose)
             for key, (path, transpose) in flax_layout(trainer.model).items()}
    params = {key: (w0[n].T if tr else w0[n]) for key, (n, tr) in names.items()}
    params, opt_state = trainer.prepare(params)
    return trainer, params, opt_state, w0, names


class Job(train_steps.Job):
    """`train_steps.Job` for DIEN: its trainer, and the columns with the
    negatives."""

    def __init__(self, ctx: harness.Context):
        import sparrowrecsys_torch.ops.metrics as M

        self.metrics = M
        cfg, tr = ctx.config, ctx.traffic
        batch, pool = tr["batch"], train_steps.POOL_BATCHES
        self.trainer, self.params, self.opt_state, self.w0, self.names = build(ctx)
        ctx.mark("trainer_built")
        feats, labels = weights_dien.train_columns(cfg, tr, ctx.seed, ctx.device, pool * batch)
        self.batches = [({k: v[i * batch:(i + 1) * batch] for k, v in feats.items()},
                         labels[i * batch:(i + 1) * batch]) for i in range(pool)]
        self.mask = torch.ones(batch, device=ctx.device)
        self.mstate = M.init_metrics(ctx.device)
        self.n = 0
        ctx.mark("columns_made")


class _Open(torch.autograd.Function):
    """Identity on a recurrence's output; its backward opens the range."""

    @staticmethod
    def forward(fctx, held, x):
        fctx.held = held
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        fctx.held.append(torch.ops.profiler._record_function_enter_new("bench.rnn_bwd", None))
        return None, g


class _Close(torch.autograd.Function):
    """Identity on a recurrence's inputs that need a gradient; its backward,
    once their gradients are made, closes the range."""

    @staticmethod
    def forward(fctx, held, *xs):
        fctx.held = held
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(fctx, *gs):
        if fctx.held:
            torch.ops.profiler._record_function_exit._RecordFunction(fctx.held.pop())
        return (None, *gs)


def _ranged(fn):
    def call(*args, **kwargs):
        where = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor) and a.requires_grad]
        if not where or not torch.is_grad_enabled():
            with torch.autograd.profiler.record_function("bench.rnn_fwd"):
                return fn(*args, **kwargs)
        held: list = []
        args = list(args)
        for i, x in zip(where, _Close.apply(held, *(args[i] for i in where))):
            args[i] = x
        with torch.autograd.profiler.record_function("bench.rnn_fwd"):
            out = fn(*args, **kwargs)
        return _Open.apply(held, out)
    return call


class RnnRanges:
    """Within the block, every call of the program's recurrences
    (`RECURRENCES` in `ops/augru.py`, where it has them) runs in a
    `bench.rnn_fwd` range and its autograd backward in a `bench.rnn_bwd`
    one."""

    def __enter__(self):
        from sparrowrecsys_torch.ops import augru

        self._mod = augru
        self._real = {n: getattr(augru, n) for n in RECURRENCES if hasattr(augru, n)}
        for n, fn in self._real.items():
            setattr(augru, n, _ranged(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self._real.items():
            setattr(self._mod, n, fn)
        return False


def run(ctx: harness.Context) -> harness.Outcome:
    cfg, tr = ctx.config, ctx.traffic
    dev = ctx.device
    cuda = torch.device(dev).type == "cuda"
    scans = scan_counters()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    job = Job(ctx)
    before = {n: fn.launches for n, fn in scans.items()}
    prog = job.checked_steps(train_steps.CHECKED_STEPS, cfg["optimizer"]["adam_b1"])
    # The CPU runs the plain loop, which launches no scan.
    ran = scans_ran(scans, before, train_steps.CHECKED_STEPS) if cuda else None
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
            with Profiled(dev) as prof, RnnRanges():
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
    batch, t, d = tr["batch"], tr["history"], cfg["dim"]
    ctx.values.update({
        "steps": steps, "window_s": window, "traced_steps": trace_steps,
        "flops_per_step": 3.0 * costs_dien.dien_flops_per_example(
            d, cfg["hidden"], t, cfg["attention_hidden"]) * batch,
        "peak_flops": cfg["peak_flops_per_s"], "batch": batch, "t": t, "dim": d,
        "att": cfg["attention_hidden"],
        # Every history id is drawn from [1, V): every step and row is live.
        "live_steps": batch * t, "live_rows": batch,
    })
    del job
    if cuda:
        torch.cuda.empty_cache()
    checks, got = compare(ctx, prog)
    return harness.Outcome(
        end_to_end={"train_examples_per_s": steps * batch / window,
                    "setup_s": ctx.values["setup_s"]},
        attempted=steps, failed=0 if final_loss == final_loss else steps,
        checks=checks, memory_peak_bytes=peak,
        notes={"window": {"steps": steps, "seconds": window, "final_loss": final_loss},
               "program_loss": prog["loss"], "checked_scan_launches": ran,
               "leaves": {k: got[k] for k in ("grad1_leaf", "change_leaf", "left_out",
                                              "grad1_by_leaf", "small_grad1_leaf",
                                              "small_change_leaf")},
               **({"trace": ctx.device_trace.summary()} if ctx.device_trace else {})})


def reference_readings(ctx: harness.Context, precision: str = "stated") -> dict:
    """The reference's readings of the checked steps, from the weights and
    batches made again from the seed."""
    cfg, tr = ctx.config, ctx.traffic
    batch, checked = tr["batch"], train_steps.CHECKED_STEPS
    w0 = weights_dien.make_dien(cfg, ctx.seed, ctx.device)
    feats, labels = weights_dien.train_columns(cfg, tr, ctx.seed, ctx.device,
                                               train_steps.POOL_BATCHES * batch)
    batches = [({k: v[i * batch:(i + 1) * batch] for k, v in feats.items()},
                labels[i * batch:(i + 1) * batch]) for i in range(checked)]
    return ref.train_readings(w0, batches, tr["history"], cfg["alpha"], cfg["optimizer"],
                              precision)


def gaps(prog: dict, refr: dict) -> dict:
    """`train_steps.gaps`, and the same two norm gaps over the leaves it
    leaves out (`small_grad1_gap`, `small_change_gap`), each such leaf's
    against the larger of its own reference norm and their median leaf's.
    At DIEN's first steps those are the attention and the AUGRU's r and z
    gates, whose gradients are a thousandth of the median leaf's, and
    Adam moves them as far as any other."""
    got = train_steps.gaps(prog, refr)
    small = got["left_out"]
    grad, grad_leaf = train_steps.ref.worst_gap(prog["grad1"], refr["grad1"], small)
    change, change_leaf = train_steps.ref.worst_gap(prog["change"], refr["change"], small)
    got.update({"small_grad1_gap": grad, "small_change_gap": change,
                "small_grad1_leaf": grad_leaf, "small_change_leaf": change_leaf})
    return got


def compare(ctx: harness.Context, prog: dict):
    """(the checks, every reading of the comparison)."""
    got = gaps(prog, reference_readings(ctx))
    limits = harness.limits_of(ctx.root, ctx.cell["name"])
    return [harness.Check(k, v, limits[k]) for k, v in got.items() if k in limits], got

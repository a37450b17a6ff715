"""Training steps: `Trainer._train_step`, the step `Trainer.fit` runs, one
after another on columns made on the card from the seed. The traffic
sets the batch, the history's length (the model's `recent_movies`), the
skew of the movie ids and the share of positive labels.

Set-up builds one trainer (model, parameters from the seed, Adam's
state), makes POOL_BATCHES batches of columns and drives the first
CHECKED_STEPS steps through the window's own call on batches that all
differ, keeping what the comparison reads: each step's loss (as the
step computes it), each leaf's first gradient (Adam's first moment after
step 1 over 1 - b1) and each leaf's change after the last checked step.
The window then steps the same trainer on, cycling the batches as an
epoch would, for `--seconds` between two synchronises.

With `--trace 1` the window's middle TRACE_STEPS steps run under the
profiler, with a range around every call of the DIN activation unit and
one around its backward; the steps before them give the step time that
`train_mfu` divides by.

After the window the program's state is freed and the reference
(`reference/din.py`) repeats the checked steps from the same weights and
batches, made again from the seed.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from benchmark import costs, harness, weights
from benchmark.reference import din as ref
from benchmark.trace import Profiled

#: Batches made at set-up and cycled through, as an epoch would.
POOL_BATCHES = 8
#: Steps compared with the reference: each loss, the first gradient, the
#: change after the last.
CHECKED_STEPS = 3
#: Steps profiled in a `--trace 1` run.
TRACE_STEPS = 20


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def build(ctx: harness.Context):
    """(trainer, params, opt_state, the weights by export name)."""
    from sparrowrecsys_torch.config import TrainConfig
    from sparrowrecsys_torch.models import build_model
    from sparrowrecsys_torch.training.checkpoint import flax_layout
    from sparrowrecsys_torch.training.loop import Trainer

    cfg, opt = ctx.config, ctx.config["optimizer"]
    model = build_model(cfg["model"], dim=cfg["dim"], hidden=cfg["hidden"],
                        attention_hidden=cfg["attention_hidden"],
                        recent_movies=ctx.traffic["history"], user_buckets=cfg["user_buckets"],
                        movie_buckets=cfg["movie_buckets"], compute_dtype=cfg["compute_dtype"])
    trainer = Trainer(model, TrainConfig(batch_size=ctx.traffic["batch"], epochs=1,
                                         learning_rate=opt["learning_rate"],
                                         adam_b1=opt["adam_b1"], adam_b2=opt["adam_b2"],
                                         adam_eps=opt["adam_eps"]),
                      device=ctx.device)
    w0 = weights.make_din(cfg, ctx.seed, ctx.device)
    names = {key: ("/".join(path), transpose)
             for key, (path, transpose) in flax_layout(trainer.model).items()}
    params = {key: (w0[n].T if tr else w0[n]) for key, (n, tr) in names.items()}
    params, opt_state = trainer.prepare(params)
    return trainer, params, opt_state, w0, names


def _leaf_moments(trainer, params, opt_state) -> Dict[str, torch.Tensor]:
    """Adam's first moment of each leaf, cut out of the optimizer's state."""
    from sparrowrecsys_torch.training.optim import split_leaves

    small, big = split_leaves(params, trainer.tx.small_max_elems, trainer.tx.leaf_sizes)
    out = {}
    pieces = opt_state.mu_vec.split([params[k].numel() for k in small]) if small else []
    for k, p in zip(small, pieces):
        out[k] = p.view(params[k].shape)
    for k, m in zip(big, opt_state.mu_big):
        out[k] = m
    return out


class DinRanges:
    """Within the block, every call of `models.din.din_attention` runs in a
    `bench.din_fwd` profiler range and its autograd backward in a
    `bench.din_bwd` one (opened by an identity on the output's gradient,
    closed by an identity on the inputs' gradients)."""

    def __enter__(self):
        from sparrowrecsys_torch.models import din as din_model

        self._mod, self._real = din_model, din_model.din_attention
        holder = {}

        class Open(torch.autograd.Function):
            @staticmethod
            def forward(fctx, x):
                return x.view_as(x)

            @staticmethod
            def backward(fctx, g):
                holder["h"] = torch.ops.profiler._record_function_enter_new("bench.din_bwd", None)
                return g

        class Close(torch.autograd.Function):
            @staticmethod
            def forward(fctx, *xs):
                return tuple(x.view_as(x) for x in xs)

            @staticmethod
            def backward(fctx, *gs):
                h = holder.pop("h", None)
                if h is not None:
                    torch.ops.profiler._record_function_exit._RecordFunction(h)
                return gs

        real = self._real

        def traced(hist, cand, *w):
            hist, cand, *w = Close.apply(hist, cand, *w)
            with torch.autograd.profiler.record_function("bench.din_fwd"):
                out = real(hist, cand, *w)
            return Open.apply(out)

        din_model.din_attention = traced
        return self

    def __exit__(self, *exc):
        self._mod.din_attention = self._real
        return False


class Job:
    """One trainer and its state, stepped through `Trainer._train_step` on
    the pool of batches, batch i % pool at step i."""

    def __init__(self, ctx: harness.Context):
        import sparrowrecsys_torch.ops.metrics as M

        self.metrics = M
        cfg, tr = ctx.config, ctx.traffic
        batch, pool = tr["batch"], POOL_BATCHES
        self.trainer, self.params, self.opt_state, self.w0, self.names = build(ctx)
        ctx.mark("trainer_built")
        feats, labels = weights.train_columns(cfg, tr, ctx.seed, ctx.device, pool * batch)
        self.batches = [({k: v[i * batch:(i + 1) * batch] for k, v in feats.items()},
                         labels[i * batch:(i + 1) * batch]) for i in range(pool)]
        self.mask = torch.ones(batch, device=ctx.device)
        self.mstate = M.init_metrics(ctx.device)
        self.n = 0
        ctx.mark("columns_made")

    def step(self) -> None:
        f, y = self.batches[self.n % len(self.batches)]
        self.params, self.opt_state, self.mstate = self.trainer._train_step(
            self.params, self.opt_state, self.mstate, f, y, self.mask)
        self.n += 1

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
        try:
            for i in range(n):
                self.step()
                if i == 0:
                    mu = _leaf_moments(self.trainer, self.params, self.opt_state)
                    prog["grad1"] = {self.names[k][0]: float((mu[k].double() / (1 - b1)).norm())
                                     for k in mu}
        finally:
            self.trainer.loss_and_grads = real
        prog["change"] = {
            name: float((self.params[k].double()
                         - (self.w0[name].T if t else self.w0[name]).double()).norm())
            for k, (name, t) in self.names.items()}
        prog["loss"] = [float(x) for x in losses]
        self.w0 = None
        return prog

    def final_loss(self) -> float:
        return float(self.metrics.finalize_metrics(self.mstate)["loss"])


def run(ctx: harness.Context) -> harness.Outcome:
    cfg, tr = ctx.config, ctx.traffic
    dev = ctx.device
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    job = Job(ctx)
    prog = job.checked_steps(CHECKED_STEPS, cfg["optimizer"]["adam_b1"])
    ctx.mark("checked_steps")
    if ctx.trace:
        Profiled.warm(dev)

    steps = 0
    trace_steps = TRACE_STEPS if ctx.trace else 0
    _sync(dev)
    t0 = time.monotonic()
    ctx.values["setup_s"] = t0 - ctx.t_start
    traced = False
    while True:
        now = time.monotonic()
        if trace_steps and not traced and now >= t0 + ctx.seconds / 2:
            _sync(dev)
            ctx.values["step_s"] = (time.monotonic() - t0) / max(steps, 1)
            with Profiled(dev) as prof, DinRanges():
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
    _sync(dev)
    window = time.monotonic() - t0
    final_loss = job.final_loss()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    batch = tr["batch"]
    d, t, h = cfg["dim"], tr["history"], cfg["attention_hidden"]
    ctx.values.update({
        "steps": steps, "window_s": window, "traced_steps": trace_steps,
        "flops_per_step": 3.0 * costs.din_flops_per_example(d, cfg["hidden"], t, h) * batch,
        "peak_flops": cfg["peak_flops_per_s"], "batch": batch, "t": t, "dim": d, "att": h,
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
               "program_loss": prog["loss"],
               "leaves": {k: got[k] for k in ("grad1_leaf", "change_leaf", "left_out",
                                              "grad1_by_leaf")},
               **({"trace": ctx.device_trace.summary()} if ctx.device_trace else {})})


def reference_readings(ctx: harness.Context, precision: str = "stated") -> dict:
    """The reference's readings of the checked steps, from the weights and
    batches made again from the seed."""
    cfg, tr = ctx.config, ctx.traffic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch, checked = tr["batch"], CHECKED_STEPS
    w0 = weights.make_din(cfg, ctx.seed, ctx.device)
    feats, labels = weights.train_columns(cfg, tr, ctx.seed, ctx.device, POOL_BATCHES * batch)
    batches = [({k: v[i * batch:(i + 1) * batch] for k, v in feats.items()},
                labels[i * batch:(i + 1) * batch]) for i in range(checked)]
    return ref.train_readings(w0, batches, tr["history"],
                              ref.DTYPES[cfg["compute_dtype"]], cfg["optimizer"], precision)


def gaps(prog: dict, refr: dict) -> dict:
    """The compared numbers (and the leaf each norm gap was widest at)."""
    keep = ref.moved_leaves(refr["grad1"])
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], refr["loss"]))
    grad, grad_leaf = ref.worst_gap(prog["grad1"], refr["grad1"], keep)
    change, change_leaf = ref.worst_gap(prog["change"], refr["change"], keep)
    return {"loss_gap": loss, "grad1_gap": grad, "change_gap": change,
            "grad1_median_gap": ref.median_gap(prog["grad1"], refr["grad1"], keep),
            "grad1_leaf": grad_leaf, "change_leaf": change_leaf,
            "grad1_by_leaf": ref.leaf_gaps(prog["grad1"], refr["grad1"], keep),
            "left_out": sorted(set(refr["grad1"]) - set(keep))}


def compare(ctx: harness.Context, prog: dict):
    """(the checks, every reading of the comparison)."""
    got = gaps(prog, reference_readings(ctx))
    limits = harness.limits_of(ctx.root, ctx.cell["name"])
    return [harness.Check(k, v, limits[k]) for k, v in got.items() if k in limits], got

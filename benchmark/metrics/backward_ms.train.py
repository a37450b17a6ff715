"""Device time a traced step of the kernels, copies and sets launched
inside the program's `trainer.backward` span (`Trainer.loss_and_grads`
around `torch.autograd.grad`), in ms.

This file also holds what the readers of the program's spans share
(`forward_ms.train`, `optimizer_ms.train`, `embedding_bwd_ms.train`,
`backward_idle_ms.train` and `host_syncs_per_step.train` load it by
path). A device event counts as launched in span S when the host call
that launched it (a `cuda_runtime` or `cuda_driver` event with the same
`correlation`) starts inside one of S's ranges, on any thread: on the
card autograd launches the backward's kernels from its own device
thread, not from the thread that holds `trainer.backward`. Each reading
is per `trainer.step` range in the window, and None where the trace
holds no such range (a program without the spans) or no device event
(a run on the CPU).
"""

import bisect

from benchmark.trace import _union

STEP = "trainer.step"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def steps(tr) -> int:
    """The `trainer.step` ranges in the window; 0 where none can be read."""
    if tr is None or not tr.in_window:
        return 0
    return len(tr.ranges(STEP))


def intervals(tr, name):
    """The union of the window's ranges named `name`, as sorted (start, end)
    pairs in microseconds."""
    return _union([(float(r["ts"]), float(r["ts"]) + float(r["dur"])) for r in tr.ranges(name)])


def inside(ivs, starts, t: float) -> bool:
    """Whether t lies in one of the sorted, disjoint intervals `ivs`, whose
    starts are `starts`."""
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= ivs[i][1]


def host_events_in(tr, name, keep):
    """The host events for which `keep(event)` holds that start inside the
    ranges named `name`."""
    ivs = intervals(tr, name)
    starts = [s for s, _ in ivs]
    return [e for e in tr.host if keep(e) and inside(ivs, starts, float(e["ts"]))]


def launched_ms(tr, name):
    """Device ms a step of what was launched inside the ranges `name`; None
    where a step or the span cannot be read."""
    n = steps(tr)
    if not n or not tr.ranges(name):
        return None
    launches = host_events_in(tr, name, lambda e: e.get("cat") in LAUNCH_CATS)
    corr = {e["args"]["correlation"] for e in launches if "correlation" in (e.get("args") or {})}
    total = sum(float(e["dur"]) for e in tr.device
                if (e.get("args") or {}).get("correlation") in corr)
    return total / 1e3 / n


def read(ctx):
    return launched_ms(ctx.device_trace, "trainer.backward")

"""Profiling and tracing: the port of `sparrowrecsys_tpu/utils/profiling.py`.

`trace()` records a `torch.profiler` trace (host, and the card's kernels
and copies when CUDA is there) and writes it into `log_dir` as a Chrome
trace (`<host>_<pid>.<time>.pt.trace.json`, which chrome://tracing,
Perfetto and TensorBoard open). `span` and `backward_span` put the
program's own ranges into such a trace: the training step's forward,
backward and optimizer and the row-Adam inside it (`training/loop.py`),
the embedding lookups' backward (`ops/embedding.py`), and the models'
layers (`dien.*` in `models/dien.py`, `dlrm.*` in `models/dlrm.py`). Tracing is on exactly while a profiler
records; otherwise a span costs one read of the profiler's flag and adds
no autograd node. `StepTimer` gives EMA-smoothed per-step
wall times and examples/s from the host clock alone; `mark_sync` waits
for the card at an epoch's end for an exact reading
(`training.loop.hard_sync`).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Iterator, List, Optional

import torch
from torch.autograd import profiler as _profiler


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """`with trace(log_dir): step()`: a torch.profiler trace of the block,
    written into `log_dir` (default `<temp dir>/sparrow_trace`)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "sparrow_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


#: What `span` returns while no profiler records (stateless, so shared).
_OFF = contextlib.nullcontext()


def span(name: str):
    """`with span(name): ...`: a profiler range `name` around the block
    while a `torch.profiler` records, else nothing."""
    return _profiler.record_function(name) if _profiler._is_profiler_enabled else _OFF


class _Open(torch.autograd.Function):
    """Identity on an op's output; its backward opens the range."""

    @staticmethod
    def forward(ctx, name, ranges, x):
        ctx.name, ctx.ranges = name, ranges
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        rf = _profiler.record_function(ctx.name)
        rf.__enter__()
        ctx.ranges.append(rf)
        return None, None, g


class _Close(torch.autograd.Function):
    """Identity on an op's differentiable inputs; its backward, once their
    gradients are made, closes the range."""

    @staticmethod
    def forward(ctx, ranges, *xs):
        ctx.ranges = ranges
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        if ctx.ranges:
            ctx.ranges.pop().__exit__(None, None, None)
        return (None, *gs)


def backward_span(name: str, fn: Callable[..., torch.Tensor], *args, **kwargs) -> torch.Tensor:
    """`fn(*args, **kwargs)`, whose autograd backward runs inside a profiler
    range `name` while a profiler records: opened when the output's
    gradient arrives, closed once the gradients of the tensor arguments
    that need one are made. Otherwise (or with nothing to differentiate)
    it is the plain call, with no autograd node added.

    On the card autograd runs the backward on its own device thread, so
    the range and its kernels' launches sit on that thread, not on the
    one that called `fn`."""
    if not _profiler._is_profiler_enabled or not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    where = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor) and a.requires_grad]
    if not where:
        return fn(*args, **kwargs)
    ranges: List[object] = []
    args = list(args)
    for i, x in zip(where, _Close.apply(ranges, *(args[i] for i in where))):
        args[i] = x
    return _Open.apply(name, ranges, fn(*args, **kwargs))


class StepTimer:
    """EMA per-step timing. Steps are launched asynchronously, so per-step
    host deltas measure the launch pace; `mark_sync(x)` waits for `x` for
    a true reading."""

    def __init__(self, batch_size: int, ema: float = 0.98):
        self.batch_size = batch_size
        self.ema = ema
        self.step_time: Optional[float] = None
        self._last: Optional[float] = None
        self.steps = 0

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.step_time = (
                dt if self.step_time is None
                else self.ema * self.step_time + (1 - self.ema) * dt
            )
        self._last = now
        self.steps += 1

    def mark_sync(self, x) -> None:
        from sparrowrecsys_torch.training.loop import hard_sync

        hard_sync(x)
        self._last = time.perf_counter()

    @property
    def examples_per_sec(self) -> float:
        if not self.step_time:
            return 0.0
        return self.batch_size / self.step_time

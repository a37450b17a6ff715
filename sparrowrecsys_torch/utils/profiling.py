"""Profiling and tracing: the port of `sparrowrecsys_tpu/utils/profiling.py`.

`trace()` records a `torch.profiler` trace (host, and the card's kernels
and copies when CUDA is there) and writes it into `log_dir` as a Chrome
trace (`<host>_<pid>.<time>.pt.trace.json`, which chrome://tracing,
Perfetto and TensorBoard open). `StepTimer` gives EMA-smoothed per-step
wall times and examples/s from the host clock alone; `mark_sync` waits
for the card at an epoch's end for an exact reading
(`training.loop.hard_sync`).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Iterator, Optional

import torch


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

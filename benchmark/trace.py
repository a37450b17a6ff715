"""The device trace of a traced run, reduced to what the metrics read.

`Profiled` runs `torch.profiler` (host and CUDA activities) over a
bounded part of the window, marked by a `bench.window` range that opens
and closes on a synchronise, and parses the Chrome trace it exports:

- `busy_s`: the union of the device's kernels, copies and sets inside
  the window (several streams overlapping count once);
- `device_ops`: how many ran, and `top_ops`: their summed time by name;
- `range_device_s(name)`: the device time of every kernel launched
  inside the host ranges of that name (a `record_function` the
  benchmark puts around a call), found by the launch's correlation id
  and by the external id of any host event inside the range, never by
  kernel name: a split, fused or renamed kernel reads the same work;
- `idle_gaps`: the device's idle time inside the window, by what the
  host was doing then (the innermost benchmark range, else the
  innermost host operation, over the gap's midpoint).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"
#: Kernel names are cut to this many characters in the breakdown (a
#: template's full name runs to thousands).
NAME_CHARS = 160


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Trace:
    """A parsed Chrome trace (`traceEvents`, times in microseconds)."""

    def __init__(self, events: List[dict]):
        self.device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        self.host = [e for e in events if e.get("ph") == "X" and e.get("cat") not in DEVICE_CATS
                     and not str(e.get("cat", "")).startswith("gpu_")]
        windows = [e for e in self.host if e.get("name") == WINDOW]
        if windows:
            w = windows[-1]
            self.lo, self.hi = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        elif self.device:
            self.lo = min(float(e["ts"]) for e in self.device)
            self.hi = max(float(e["ts"]) + float(e["dur"]) for e in self.device)
        else:
            self.lo = self.hi = 0.0
        self.in_window = [e for e in self.device if float(e["ts"]) < self.hi
                          and float(e["ts"]) + float(e["dur"]) > self.lo]

    def summary(self) -> dict:
        """Counts for the run's log: device events in all and in the window."""
        return {"device_events": len(self.device), "in_window": len(self.in_window),
                "host_events": len(self.host), "window_us": [self.lo, self.hi],
                "device_us": [min((float(e["ts"]) for e in self.device), default=None),
                              max((float(e["ts"]) for e in self.device), default=None)]}

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def _clipped(self) -> List[Tuple[float, float]]:
        return [(max(float(e["ts"]), self.lo), min(float(e["ts"]) + float(e["dur"]), self.hi))
                for e in self.in_window]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in _union(self._clipped())) / 1e6

    @property
    def device_ops(self) -> int:
        return len(self.in_window)

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for e in self.in_window:
            name = e["name"][:NAME_CHARS]
            by[name] = by.get(name, 0.0) + float(e["dur"]) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def ranges(self, name: str) -> List[dict]:
        return [e for e in self.host if e.get("name") == name
                and self.lo <= float(e["ts"]) <= self.hi]

    def range_device_s(self, name: str) -> Tuple[float, int]:
        """(device seconds of the kernels launched inside the ranges named
        `name`, number of such ranges)."""
        found = self.ranges(name)
        if not found:
            return 0.0, 0
        by_tid: Dict[object, List[dict]] = {}
        for e in self.host:
            by_tid.setdefault(e.get("tid"), []).append(e)
        corr, ext = set(), set()
        for r in found:
            s, t = float(r["ts"]), float(r["ts"]) + float(r["dur"])
            for e in by_tid.get(r.get("tid"), ()):
                if s <= float(e["ts"]) <= t:
                    args = e.get("args") or {}
                    if "correlation" in args:
                        corr.add(args["correlation"])
                    if "External id" in args and e is not r:
                        ext.add(args["External id"])
            args = r.get("args") or {}
            if "External id" in args:
                ext.add(args["External id"])
        total = 0.0
        for e in self.device:
            args = e.get("args") or {}
            if args.get("correlation") in corr or args.get("External id") in ext:
                total += float(e["dur"]) / 1e6
        return total, len(found)

    def idle_gaps(self, n: int = 10) -> List[list]:
        busy = _union(self._clipped())
        gaps, cursor = [], self.lo
        for s, e in busy:
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        if cursor < self.hi:
            gaps.append((cursor, self.hi))
        spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e)
                        for e in self.host if e.get("name") != WINDOW
                        and not str(e.get("name", "")).startswith("PyTorch Profiler")),
                       key=lambda x: x[0])
        starts = [s for s, _, _ in spans]
        by: Dict[str, float] = {}
        for s, e in gaps:
            mid = (s + e) / 2
            hi = bisect.bisect_right(starts, mid)
            best: Optional[Tuple[int, float, str]] = None
            for i in range(hi - 1, max(-1, hi - 4000), -1):
                a, b, ev = spans[i]
                if b >= mid:
                    bench = str(ev.get("name", "")).startswith("bench.")
                    key = (1 if bench else 0, a)
                    if best is None or key > best[:2]:
                        best = (key[0], key[1], ev["name"])
            label = best[2][:NAME_CHARS] if best else "no host operation"
            by[label] = by.get(label, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _all_threads():
    import torch

    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


class Profiled:
    """`with Profiled(device) as p: ...` profiles the block between two
    synchronises; `p.trace` is the parsed Trace afterwards. The exported
    trace goes to the temporary directory and is deleted once read."""

    def __init__(self, device):
        self.device = device
        self.trace: Optional[Trace] = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        # Threads that started before the profiler (a server's handlers)
        # are profiled only when asked for; without their host events the
        # kernels they launch are left out of the trace too.
        self._prof = profile(activities=acts, experimental_config=_all_threads())
        self._prof.__enter__()
        self._sync()
        self._range = torch.autograd.profiler.record_function(WINDOW)
        self._range.__enter__()
        return self

    @staticmethod
    def warm(device) -> None:
        """Start and stop the profiler once: its first start (CUPTI and its
        threads) takes seconds and stalls every thread of the process, so
        a traced run pays it in set-up, not in the traced part."""
        with Profiled(device):
            pass

    def _sync(self):
        import torch

        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def __exit__(self, *exc):
        self._sync()
        self._range.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                self.trace = Trace(json.load(f).get("traceEvents", []))
        finally:
            os.unlink(path)
        return False

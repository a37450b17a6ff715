"""What every cell shares: finding its files by name, the environment, the
card check, spans, the per-layer readers, and the result line.

The module of a cell's traffic kind (`drivers/<kind>.py`, the traffic
file's `kind`) gets a `Context` and returns an `Outcome`; the harness
adds the per-layer metrics its readers find in the context and prints
the line.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

#: Top-level module names that no run may have loaded once its window has
#: closed: JAX and the JAX package the program was ported from.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sparrowrecsys_tpu")
#: Build and kernel caches, at fixed paths inside the checkout.
CACHE_DIR = ".bench_cache"


class NoCard(RuntimeError):
    """The machine has no card, or fewer than the cell asks for."""


class LoadedJax(RuntimeError):
    """The run loaded JAX or the JAX package."""


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def set_cache_env(root: str) -> None:
    """Every compile cache a run may fill, inside the checkout at a fixed
    path, so that only the first run of a checkout builds."""
    base = os.path.join(root, CACHE_DIR)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(root: str, workload: str) -> Tuple[dict, dict, dict, dict]:
    """(BENCHMARK.json, the cell, its configuration, its traffic), each
    found by name under `root`."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(root, "benchmark", "traffic", f"{cell['traffic']}.json"))
    return bench, cell, config, traffic


def limits_of(root: str, workload: str) -> Dict[str, float]:
    """The limits of a cell's compared numbers, `benchmark/limits/<cell>.json`."""
    return load_json(os.path.join(root, "benchmark", "limits", f"{workload}.json"))


def applies(metric: dict, cell: str, reported: List[str]) -> bool:
    """Whether `metric` is reported in `cell`: listed there, or, without a
    list, wherever the end-to-end metric it moves is."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def require_card(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("no CUDA card: the benchmark measures the port on an NVIDIA GPU")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, the machine has "
                     f"{torch.cuda.device_count()}")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN})


class Spans:
    """Durations in seconds by span name, recorded from the benchmark's
    wrappers around the program's calls; appends are atomic under the
    interpreter lock, so server threads may record concurrently."""

    def __init__(self):
        self.by: Dict[str, List[float]] = {}
        self.on = True

    def record(self, name: str, seconds: float) -> None:
        if self.on:
            self.by.setdefault(name, []).append(seconds)

    def wrap(self, fn: Callable, name: str, traced: bool = False,
             keep: Optional[Callable] = None) -> Callable:
        """`fn` timed into span `name` (only calls where `keep(*args)` holds,
        if given); under `traced` also a `bench.<name>` profiler range."""
        if traced:
            from torch.autograd.profiler import record_function

        def call(*args, **kwargs):
            t0 = time.monotonic()
            try:
                if traced:
                    with record_function(f"bench.{name}"):
                        return fn(*args, **kwargs)
                return fn(*args, **kwargs)
            finally:
                if keep is None or keep(*args, **kwargs):
                    self.record(name, time.monotonic() - t0)
        return call

    def median_ms(self, name: str) -> Optional[float]:
        got = self.by.get(name)
        return statistics.median(got) * 1e3 if got else None


@dataclasses.dataclass
class Context:
    """What a traffic kind's module and the per-layer readers share about
    one run."""

    root: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: int
    trace: bool
    device: str = "cuda"
    spans: Spans = dataclasses.field(default_factory=Spans)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    values: Dict[str, float] = dataclasses.field(default_factory=dict)
    device_trace: object = None
    t_start: float = 0.0
    setup: Dict[str, float] = dataclasses.field(default_factory=dict)

    def mark(self, phase: str) -> None:
        """Seconds from the process's start to the end of a set-up phase,
        printed on an earlier line of standard error."""
        self.setup[phase] = time.monotonic() - self.t_start


@dataclasses.dataclass
class Check:
    """One number compared with its limit: it passes at or below it."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Check]
    memory_peak_bytes: int
    notes: Dict[str, object] = dataclasses.field(default_factory=dict)


def load_reader(root: str, name: str):
    """The `read(ctx)` of `benchmark/metrics/<name>.py`."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer(ctx: Context, bench: dict, reported: List[str]) -> Dict[str, dict]:
    out = {}
    for m in bench["per_layer"]:
        if not applies(m, ctx.cell["name"], reported):
            continue
        value = load_reader(ctx.root, m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def idle_percent(ctx: Context) -> Optional[float]:
    tr = ctx.device_trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def roofline_percent(ctx: Context, name: str, cost) -> Optional[float]:
    """The least time of the op's work at the traced shapes (the longer of
    its bytes at the HBM rate and its operations at the TF32 peak) over
    the device time per call of the kernels inside the ranges `name`."""
    from benchmark import peaks

    tr = ctx.device_trace
    if tr is None:
        return None
    seconds, calls = tr.range_device_s(name)
    if not calls or seconds <= 0:
        return None
    v = ctx.values
    nbytes, flops = cost(v["batch"], v["t"], v["dim"], v["att"], v["live_steps"], v["live_rows"])
    least = max(nbytes / peaks.HBM_BYTES_PER_S, flops / peaks.TF32_FLOPS)
    return 100.0 * least / (seconds / calls)


def card_label() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def run_cell(root: str, workload: str, seed: int, seconds: int, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             stdout=None, stderr=None) -> dict:
    """Run one cell once; print its lines; return the result."""
    stdout = stdout or sys.stdout
    stderr = stderr or sys.stderr
    bench, cell, config, traffic = resolve(root, workload)
    ctx = Context(root=root, cell=cell, config=config, traffic=traffic, seed=seed,
                  seconds=seconds, trace=trace, device=device,
                  t_start=time.monotonic() if t_start is None else t_start)
    import torch  # noqa: F401

    ctx.mark("torch_imported")
    if device == "cuda":
        require_card(int(cell["chips"]))
        ctx.mark("card_found")
    kind = importlib.import_module(f"benchmark.drivers.{traffic['kind']}")
    outcome: Outcome = kind.run(ctx)
    found = forbidden_modules()
    if found:
        raise LoadedJax(f"modules of JAX or the JAX package were loaded: {found}")
    e2e = [m for m in bench["end_to_end"] if applies(m, workload, [m["name"]])]
    reported = [m["name"] for m in e2e]
    if trace:
        metrics = per_layer(ctx, bench, reported)
    else:
        metrics = {m["name"]: {"value": float(outcome.end_to_end[m["name"]]), "unit": m["unit"]}
                   for m in e2e}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": _device_name(device), "count": int(cell["chips"]),
           "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    result = {"correct": all(c.ok for c in outcome.checks),
              "attempted": int(outcome.attempted), "failed": int(outcome.failed),
              "metrics": metrics, "device": dev}
    if trace and ctx.device_trace is not None:
        tr = ctx.device_trace
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    if ctx.setup:
        print(f"[bench] setup: {json.dumps(ctx.setup)}", file=stderr)
    for k, v in outcome.notes.items():
        print(f"[bench] {k}: {json.dumps(v)}", file=stderr)
    if device == "cuda":
        print(f"[bench] card: {card_label()}", file=stderr)
    for c in outcome.checks:
        print(f"[check] {c.name} = {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=stderr)
    stderr.flush()
    print(json.dumps(result), file=stdout)
    stdout.flush()
    return result


def _device_name(device: str) -> str:
    import torch

    if device == "cuda":
        return torch.cuda.get_device_name(0)
    return "cpu"

"""A copy of the benchmark's files at sizes a CPU test run holds: the same
BENCHMARK.json with the serving cell added, configurations, metrics and
drivers, with the training batch cut to 256 rows, a serving rate of 30
requests/s, and the drivers' set-up and check sizes cut by `shrink`."""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TRAIN_TRAFFIC = {"batch": 256}
SERVE_TRAFFIC = {"rate_per_s": 30}
#: The serving cell's entries, which BENCHMARK.json does not hold yet (its
#: latency spreads too widely on the card's host; PERF.md, Open
#: questions): the tests run its driver, readers and reference through
#: them.
SERVE_CELL = {
    "workloads": [{"name": "din_sparrow.serve", "config": "din_sparrow", "traffic": "serve",
                   "chips": 1, "why": "open-loop /getrecforyou"}],
    "end_to_end": [
        {"name": "rec_p50_ms", "unit": "ms", "better": "lower", "bound": 0.25,
         "source": "host_clock", "workloads": ["din_sparrow.serve"]},
        {"name": "rec_served_per_s", "unit": "requests/s", "better": "higher", "bound": 0.01,
         "source": "host_clock", "workloads": ["din_sparrow.serve"]}],
    "per_layer": [
        {"name": name, "unit": unit, "better": better, "source": source, "layer": layer,
         "moves": "rec_p50_ms", "workloads": ["din_sparrow.serve"]}
        for name, unit, better, source, layer in (
            ("rec_p95_ms", "ms", "lower", "host_clock", "Whole request, client side"),
            ("handle_ms.serve", "ms", "lower", "program_span", "Recall + rank"),
            ("wave_fill.serve", "requests/wave", "higher", "program_counter", "Batcher"),
            ("score_wave_ms.serve", "ms", "lower", "program_span", "Scorer"),
            ("device_idle.serve", "%", "lower", "device_trace", "Device"))],
}


def shrink() -> None:
    """The drivers' set-up and check sizes, cut for a CPU run."""
    from benchmark.drivers import http_open_loop as serve
    from benchmark.drivers import train_steps as train

    train.POOL_BATCHES, train.TRACE_STEPS = 4, 2
    serve.DRAIN_S, serve.TRACE_S, serve.CHECK_SAMPLE, serve.START_DELAY_S = 20.0, 0.5, 16, 0.3


def make_root(dest: str) -> str:
    """A benchmark root under `dest`: BENCHMARK.json and benchmark/'s data
    files, the traffic cut to CPU sizes."""
    os.makedirs(os.path.join(dest, "benchmark"), exist_ok=True)
    for sub in ("metrics", "traffic", "configs", "limits"):
        shutil.copytree(os.path.join(REPO, "benchmark", sub), os.path.join(dest, "benchmark", sub),
                        dirs_exist_ok=True)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), os.path.join(dest, "BENCHMARK.json"))

    def edit(rel, changes):
        path = os.path.join(dest, rel)
        with open(path) as f:
            obj = json.load(f)
        obj.update(changes)
        with open(path, "w") as f:
            json.dump(obj, f, indent=1)

    edit("benchmark/configs/din_sparrow.json", {"data_root": os.path.join(REPO, "data")})
    edit("benchmark/traffic/train_long.json", TRAIN_TRAFFIC)
    edit("benchmark/traffic/serve.json", SERVE_TRAFFIC)
    path = os.path.join(dest, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    for key, entries in SERVE_CELL.items():
        bench[key] = bench[key] + entries
    with open(path, "w") as f:
        json.dump(bench, f, indent=1)
    return dest

"""The readings that the limits of `correct` are set from, at a cell's own
size, in one process.

    python -m benchmark.readings --workload <cell> --seeds 1,2,... \
        [--control-seeds a,b,c] [--faults half_batch,altered_answer] \
        [--fault-seeds x,y,z] [--seconds 3] [--out FILE]

For each seed of `--seeds`, the program's sound readings: a training
cell's checked steps (no window), or a serving cell's short window at
the cell's own rate, each compared with the reference. For each seed of
`--control-seeds`, the control: the reference computed one precision
step below the stated one, put in the program's place. For each fault
of `--faults` (`benchmark/faults.py`) and each seed of `--fault-seeds`,
the program with that fault planted. One JSON line per reading, on
standard output and, with `--out`, appended to FILE.

Not run by the benchmark's runs; it needs the card, as they do.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def train_reading(ctx, kind: str, fault=None) -> dict:
    import torch

    from benchmark.drivers import train_steps as drv

    if kind == "control":
        got = drv.reference_readings(ctx, precision="lower")
    else:
        with fault() if fault else contextlib.nullcontext():
            job = drv.Job(ctx)
            got = job.checked_steps(drv.CHECKED_STEPS, ctx.config["optimizer"]["adam_b1"])
        del job
        torch.cuda.empty_cache()
    return drv.gaps(got, drv.reference_readings(ctx))


def serve_reading(ctx, kind: str, fault=None) -> dict:
    from benchmark.drivers import http_open_loop as drv
    from benchmark.reference import din as ref

    if kind == "control":
        users = drv.users_of(os.path.join(ctx.root, ctx.config["data_root"]))
        requests = drv.schedule(ctx.traffic, users, ctx.seed, ctx.seconds,
                                ctx.traffic["rate_per_s"])

        def control(w, feats):
            return ref.logits_in_blocks(w, feats, ctx.config["recent_movies"],
                                        ref.DTYPES[ctx.config["compute_dtype"]],
                                        precision="lower")

        return drv.served_gaps(ctx, requests, [None] * len(requests), served_logits=control)
    with fault() if fault else contextlib.nullcontext():
        serving = drv.Serving(ctx)
        try:
            users = drv.users_of(serving.data_root)
            rows, stats, requests, _ = drv.window(serving, ctx, ctx.traffic["rate_per_s"],
                                                  ctx.seconds, ctx.seed, users)
        finally:
            serving.close()
    got = drv.served_gaps(ctx, requests, rows)
    got["p95_ms"] = stats["p95_ms"]
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=int, default=3)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    from benchmark import faults, harness

    root = harness.repo_root()
    harness.set_cache_env(root)
    _, cell, config, traffic = harness.resolve(root, args.workload)
    harness.require_card(int(cell["chips"]))
    reading = serve_reading if traffic["kind"] == "http_open_loop" else train_reading
    plan = [("sound", s, None) for s in _seeds(args.seeds)]
    plan += [("control", s, None) for s in _seeds(args.control_seeds)]
    plan += [(f, s, faults.FAULTS[f]) for f in args.faults.split(",") if f
             for s in _seeds(args.fault_seeds)]
    for kind, seed, fault in plan:
        ctx = harness.Context(root=root, cell=cell, config=config, traffic=traffic,
                              seed=seed, seconds=args.seconds, trace=False)
        t0 = time.monotonic()
        got = reading(ctx, kind if kind == "control" else "program", fault)
        line = json.dumps({"workload": args.workload, "kind": kind, "seed": seed,
                           "seconds": time.monotonic() - t0, **got})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    print(f"[readings] card: {harness.card_label()}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

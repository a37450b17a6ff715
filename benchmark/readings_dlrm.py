"""The readings that the limits of a DLRM-DCNv2 training cell's `correct`
are set from, at the cell's own size, in one process: `readings.py`'s
readings for the cells of `drivers/dlrm_train_steps.py`.

    python -m benchmark.readings_dlrm --workload <cell> --seeds 1,2,... \
        [--control-seeds a,b,c] [--faults half_batch,unchanged_state] \
        [--fault-seeds x,y,z] [--out FILE]

For each seed of `--seeds`, the program's checked steps compared with the
reference; for each seed of `--control-seeds`, the reference computed
with TF32-rounded products put in the program's place; for each fault of
`--faults` (`benchmark/faults.py`) and each seed of `--fault-seeds`, the
program with that fault planted. One JSON line per reading, on standard
output and, with `--out`, appended to FILE. Not run by the benchmark's
runs; it needs the card, as they do.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from benchmark.readings import _seeds


def reading(ctx, kind: str, fault=None) -> dict:
    import torch

    from benchmark.drivers import dlrm_train_steps as drv
    from benchmark.drivers import train_steps

    sparse = drv.sparse_names(ctx.config)
    if kind == "control":
        got = drv.reference_readings(ctx, sparse, precision="lower")
    else:
        with fault() if fault else contextlib.nullcontext():
            job = drv.Job(ctx)
            got = job.checked_steps(train_steps.CHECKED_STEPS, ctx.config["optimizer"]["adam_b1"])
        del job
        torch.cuda.empty_cache()
    return drv.gaps(got, drv.reference_readings(ctx, sparse), sparse)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    from benchmark import faults, harness

    root = harness.repo_root()
    harness.set_cache_env(root)
    _, cell, config, traffic = harness.resolve(root, args.workload)
    harness.require_card(int(cell["chips"]))
    plan = [("sound", s, None) for s in _seeds(args.seeds)]
    plan += [("control", s, None) for s in _seeds(args.control_seeds)]
    plan += [(f, s, faults.FAULTS[f]) for f in args.faults.split(",") if f
             for s in _seeds(args.fault_seeds)]
    for kind, seed, fault in plan:
        ctx = harness.Context(root=root, cell=cell, config=config, traffic=traffic,
                              seed=seed, seconds=0, trace=False)
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

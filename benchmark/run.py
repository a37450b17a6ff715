"""Run one cell of `BENCHMARK.json` once.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1`
`breakdown`, and last `checks`, each number compared beside its limit
(also the last lines of standard error). Exits 3 without printing a
result on a machine without a CUDA card, 4 if the run loaded JAX or the
JAX package.
"""

from __future__ import annotations

import time

_T_START = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from benchmark import harness

    root = harness.repo_root()
    harness.set_cache_env(root)
    try:
        harness.run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace),
                         t_start=_T_START)
    except harness.NoCard as e:
        print(f"[bench] {e}", file=sys.stderr)
        return 3
    except harness.LoadedJax as e:
        print(f"[bench] {e}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)

"""The knee of a serving cell: the highest offered rate that the server
keeps up with, by a sweep of open-loop windows on one started server.

    python -m benchmark.knee --workload din_sparrow.serve --seed N \
        --rates 100,200,300 [--seconds 20] [--out FILE]

For each rate, one window of the cell's traffic at that rate (the same
generator, users and senders as the cell) prints a row: offered and
answered rates, p50, p95 and p99 ms, failures, the senders' lateness,
the requests a wave carried, and `growth`, the median latency of the
window's second half over its first half. A rate is kept up with when
the answered rate is within 1% of the offered one, at most 1% of the
requests failed (a stall of the machine sheds a few) and growth stays
under 1.5: a queue that grows through the window, not one stall, fails
it. A sweep's knee is the highest such rate below the first that is
not, where the sweep stops; the sweep runs SWEEPS times on the same
server with other seeds, and the knee taken is the least of the
sweeps'. The cell runs at about four fifths of it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

#: Sweeps, one after another: a knee that one stall of the machine moves
#: shows as two sweeps that disagree.
SWEEPS = 2


def growth(requests, rows, seconds: float) -> float:
    first = [r[2] for (_, off, _), r in zip(requests, rows)
             if r[2] is not None and off < seconds / 2]
    last = [r[2] for (_, off, _), r in zip(requests, rows)
            if r[2] is not None and off >= seconds / 2]
    if not first or not last:
        return float("inf")
    return statistics.median(last) / statistics.median(first)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="din_sparrow.serve")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=int, default=20)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    from benchmark import harness
    from benchmark.drivers import http_open_loop as drv

    root = harness.repo_root()
    harness.set_cache_env(root)
    _, cell, config, traffic = harness.resolve(root, args.workload)
    harness.require_card(int(cell["chips"]))
    ctx = harness.Context(root=root, cell=cell, config=config, traffic=traffic,
                          seed=args.seed, seconds=args.seconds, trace=False)
    serving = drv.Serving(ctx)
    rates = [float(r) for r in args.rates.split(",")]
    knees = []
    try:
        users = drv.users_of(serving.data_root)
        for sweep in range(SWEEPS):
            knees.append(_sweep(serving, ctx, rates, args, sweep, users))
    finally:
        serving.close()
    print(json.dumps({"knees_per_s": knees, "knee_per_s": min(knees, key=lambda k: k or 0),
                      "card": harness.card_label()}), flush=True)
    return 0


def _sweep(serving, ctx, rates, args, sweep: int, users):
    from benchmark.drivers import http_open_loop as drv

    knee, broke = None, False
    for i, rate in enumerate(rates):
        ctx.spans.by.clear()
        rows, stats, requests, _ = drv.window(serving, ctx, rate, args.seconds,
                                              args.seed + 1000 * sweep + i, users)
        row = {"sweep": sweep, "offered_per_s": rate, **stats,
               "growth": growth(requests, rows, args.seconds),
               "wave_fill": ctx.counters["wave_requests"] / max(1, ctx.counters["waves"]),
               "handle_ms": ctx.spans.median_ms("handle"),
               "score_wave_ms": ctx.spans.median_ms("score_wave")}
        kept = (stats["served_per_s"] >= 0.99 * rate and stats["failed"] <= 0.01 * len(rows)
                and row["growth"] < 1.5)
        row["kept_up"] = kept
        if kept and not broke:
            knee = rate
        broke = broke or not kept
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        if broke:
            break
    return knee


if __name__ == "__main__":
    sys.exit(main())

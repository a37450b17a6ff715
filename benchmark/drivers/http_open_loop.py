"""Ranked requests over HTTP in an open loop: `/getrecforyou` into the
port's `RecSysServer`, as its command line builds it.

Set-up makes the configuration's weights on the card from the seed and
writes them as a versioned export into a temporary directory, builds the
server through `serving.server.server_from_args` (`--rank-model`,
`--rank-model-dir`, `--data-root`: `ModelScorer` loads the export,
`ServingConfig`'s defaults), starts it on a free port, warms it up
(`RecSysServer.warmup`: every shape a wave uses) and wraps, from
outside, `RecSysServer.handle` and the scorer's `score_wave` in spans.

The window: `rate_per_s * seconds` requests, Poisson arrivals (one set
of gaps, in an order drawn from the seed; `schedule`), users drawn
Zipf(`user_zipf_s`) over the users of `ratings.csv` in an order drawn
from the seed, sent by SENDERS processes of `benchmark/loadgen.py`.
Every request due in the window is waited for, up to DRAIN_S past its
close. Latency runs from the scheduled send to the parsed response; a
request that failed or never came counts as missing every limit.

`correct`: every answered list is `size` distinct movies of the
candidate set, every request was answered, and for a sample of answered
requests drawn from the seed the reference (`reference/catalog.py`,
`reference/din.py`) ranks the candidates again: the widest gap by which
the logit of the movie served at a place lies below the reference's
logit at that place, over the sample, is held to its limit.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import harness, weights
from benchmark.reference import din as ref
from benchmark.reference.catalog import Catalog
from benchmark.trace import Profiled

#: Latency charged to a request that failed or never came, in seconds
#: past its scheduled send: more than any limit.
MISSING_S = 3600.0
#: The generator of the one set of gaps between arrivals that every seed
#: puts in its own order.
ARRIVALS_SEED = 20260101
#: Sender processes, each on a core of its own where the machine has some
#: to spare.
SENDERS = 2
#: Requests sent over HTTP at set-up, before the window.
WARM_REQUESTS = 32
#: From the senders' start to the window's first scheduled send.
START_DELAY_S = 0.5
#: How long past the window's close a request due in it is waited for.
DRAIN_S = 60.0
#: The window's last seconds, profiled in a `--trace 1` run.
TRACE_S = 1.0
#: Answered requests drawn from the seed that the reference ranks again.
CHECK_SAMPLE = 256


class Serving:
    """The started server, its export and its spans."""

    def __init__(self, ctx: harness.Context):
        from sparrowrecsys_torch.training.checkpoint import save

        self.ctx = ctx
        cfg = ctx.config
        self.cores = os.sched_getaffinity(0)
        server_cores, self.sender_cores = split_cores(SENDERS)
        os.sched_setaffinity(0, server_cores)
        self.data_root = os.path.join(ctx.root, cfg["data_root"])
        self.export = tempfile.mkdtemp(prefix="bench_export_")
        w = weights.make_din(cfg, ctx.seed, ctx.device)
        tree: Dict[str, dict] = {}
        for name, t in w.items():
            node = tree
            parts = name.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = t.cpu().numpy()
        save(tree, self.export, meta={"model": cfg["model"]})
        del w
        ctx.mark("export_written")
        os.environ["PORT"] = "0"
        from sparrowrecsys_torch.serving.server import server_from_args

        argv = ["--data-root", self.data_root, "--rank-model", cfg["model"],
                "--rank-model-dir", self.export]
        if ctx.device == "cpu":
            argv.append("--cpu")
        self.server = server_from_args(argv)
        ctx.mark("server_built")
        spans = ctx.spans
        self.server.handle = spans.wrap(self.server.handle, "handle", traced=ctx.trace,
                                        keep=lambda path, q: path == "/getrecforyou")
        self.scorer = self.server.rec_for_you.scorers[cfg["model"]]
        self.server.start()
        self.server.warmup()
        ctx.mark("server_warmed")
        if ctx.trace:
            Profiled.warm(ctx.device)
        self.scorer.score_wave = spans.wrap(self.scorer.score_wave, "score_wave",
                                            traced=ctx.trace)
        self._warm_path(users_of(self.data_root)[:WARM_REQUESTS])
        ctx.mark("path_warmed")
        spans.by.clear()

    def _warm_path(self, users: List[int]) -> None:
        """A few requests over HTTP before the window: the connection, the
        batcher (made at a model's first request) and the movies' cached
        JSON are ready when it opens."""
        import urllib.request

        size, model = self.ctx.traffic["size"], self.ctx.config["model"]
        for u in users:
            url = (f"http://127.0.0.1:{self.server.port}/getrecforyou?id={u}&size={size}"
                   f"&model={model}")
            with urllib.request.urlopen(url, timeout=60) as r:
                r.read()

    def batcher_counts(self):
        b = self.server.rec_for_you._model_batchers.get(self.ctx.config["model"])
        return (b.n_requests, b.n_waves) if b is not None else (0, 0)

    def close(self):
        self.server.stop()
        shutil.rmtree(self.export, ignore_errors=True)
        os.sched_setaffinity(0, self.cores)


def users_of(data_root: str) -> List[int]:
    """The users of `ratings.csv`, in the order they first appear."""
    import csv

    seen: Dict[int, None] = {}
    with open(os.path.join(data_root, "ratings.csv"), newline="") as f:
        for row in list(csv.reader(f))[1:]:
            seen.setdefault(int(row[0]), None)
    return list(seen)


def schedule(traffic: dict, users: List[int], seed: int, seconds: float, rate: float):
    """[(k, offset_s, user)] of the window's requests.

    The gaps between arrivals are one fixed set of exponential draws for
    every seed (a Poisson process of `rate * seconds` arrivals over the
    window), put in an order drawn from the seed, so that seeds differ in
    where the bursts fall and who sends, not in how bursty the window is.
    Users: Zipf(`user_zipf_s`) ranks over the users, in an order drawn
    from the seed."""
    n = int(round(rate * seconds))
    gaps = np.random.default_rng(ARRIVALS_SEED).exponential(1.0, n + 1)
    rng = np.random.default_rng(weights.sub_seed(seed, 3))
    gaps = np.concatenate([gaps[:1], rng.permutation(gaps[1:n]), gaps[n:]])
    offsets = np.cumsum(gaps)[:n] * (seconds / gaps.sum())
    order = rng.permutation(len(users))
    p = 1.0 / np.arange(1, len(users) + 1) ** traffic["user_zipf_s"]
    ranks = rng.choice(len(users), size=n, p=p / p.sum())
    return [(k, float(offsets[k]), users[order[ranks[k]]]) for k in range(n)]


def split_cores(senders: int):
    """(the server's cores, the senders' cores): the last `senders` of the
    cores this process may use go to the senders, as clients on other
    machines would take none of the server's."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) <= 2 * senders:
        return cores, cores
    return cores[:-senders], cores[-senders:]


def start_senders(port: int, model: str, requests, traffic: dict, t0: float,
                  seconds: float, cores=None):
    """Start SENDERS processes, each with its share of the requests."""
    procs = []
    size = traffic["size"]
    for i in range(SENDERS):
        job = {"host": "127.0.0.1", "port": port, "t0": t0, "cores": cores,
               "drain_until": t0 + seconds + DRAIN_S,
               "requests": [[k, off, f"/getrecforyou?id={u}&size={size}&model={model}"]
                            for k, off, u in requests[i::SENDERS]]}
        p = subprocess.Popen([sys.executable, "-m", "benchmark.loadgen"],
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                             cwd=harness.repo_root(), text=True)
        procs.append(p)
        p.stdin.write(json.dumps(job))
        p.stdin.close()
    return procs


def collect(procs, timeout: float) -> List[list]:
    """The senders' rows, by k, once each has ended; any still running at
    `timeout` is killed."""
    rows: List[list] = []
    try:
        for p in procs:
            out = p.stdout.read()
            p.wait(timeout=timeout)
            rows.extend(json.loads(out)["rows"])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return sorted(rows, key=lambda r: r[0])


def latency_stats(rows: List[list], requests, seconds: float) -> dict:
    """The window's latency percentiles (a failed request counts as
    MISSING_S), the rate answered before the window closed, and how late
    the senders ran."""
    ok = [r[2] is not None and r[3] == 200 for r in rows]
    lat = sorted(r[2] if good else MISSING_S for r, good in zip(rows, ok))

    def pct(q):
        return lat[min(len(lat) - 1, max(0, int(np.ceil(q * len(lat))) - 1))] * 1e3

    late = sorted(r[1] for r in rows if r[1] is not None)
    return {
        "requests": len(rows), "p50_ms": pct(0.50), "p95_ms": pct(0.95), "p99_ms": pct(0.99),
        "served_per_s": sum(1 for (_, off, _), r, good in zip(requests, rows, ok)
                            if good and off + r[2] <= seconds) / seconds,
        "failed": len(rows) - sum(ok),
        "lateness_p99_ms": late[int(0.99 * (len(late) - 1))] * 1e3 if late else None,
        "lateness_max_ms": late[-1] * 1e3 if late else None,
    }


def window(serving: Serving, ctx: harness.Context, rate: float, seconds: float,
           seed: int, users: List[int]):
    """One open-loop window: (rows, stats, the window's requests, t0).

    With `ctx.trace` the window's last TRACE_S seconds run under the
    profiler, from this thread; spans stop and the batcher's counts are
    read as it starts, so that the per-layer numbers are of the untraced
    part."""
    requests = schedule(ctx.traffic, users, seed, seconds, rate)
    t0 = time.monotonic() + START_DELAY_S
    n0 = serving.batcher_counts()
    procs = start_senders(serving.server.port, ctx.config["model"], requests, ctx.traffic,
                          t0, seconds, serving.sender_cores)
    try:
        if ctx.trace:
            time.sleep(max(0.0, t0 + seconds - TRACE_S - time.monotonic()))
            ctx.spans.on = False
            n1 = serving.batcher_counts()
            with Profiled(ctx.device) as prof:
                time.sleep(TRACE_S)
            ctx.device_trace = prof.trace
        rows = collect(procs, seconds + DRAIN_S + 60)
    finally:
        ctx.spans.on = True
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if not ctx.trace:
        n1 = serving.batcher_counts()
    ctx.counters["wave_requests"] = n1[0] - n0[0]
    ctx.counters["waves"] = n1[1] - n0[1]
    return rows, latency_stats(rows, requests, seconds), requests, t0


def run(ctx: harness.Context) -> harness.Outcome:
    serving = Serving(ctx)
    try:
        users = users_of(serving.data_root)
        rows, stats, requests, t0 = window(serving, ctx, ctx.traffic["rate_per_s"],
                                           ctx.seconds, ctx.seed, users)
        ctx.values["setup_s"] = t0 - ctx.t_start
        peak = torch.cuda.max_memory_allocated() if ctx.device == "cuda" else 0
    finally:
        serving.close()
    if ctx.trace:
        # The per-layer tail: the requests due before the profiler started.
        cut = ctx.seconds - TRACE_S
        kept = [(q, r) for q, r in zip(requests, rows) if q[1] < cut]
        ctx.values["rec_p95_ms"] = latency_stats([r for _, r in kept], [q for q, _ in kept],
                                                 cut)["p95_ms"]
    checks = compare(ctx, requests, rows)
    return harness.Outcome(
        end_to_end={"rec_p50_ms": stats["p50_ms"], "rec_served_per_s": stats["served_per_s"],
                    "setup_s": ctx.values["setup_s"]},
        attempted=len(rows), failed=stats["failed"], checks=checks, memory_peak_bytes=peak,
        notes={"window": stats, "waves": ctx.counters,
               **({"trace": ctx.device_trace.summary()} if ctx.device_trace else {})})


def served_gaps(ctx: harness.Context, requests, rows, served_logits=None) -> dict:
    """The checks' readings: lists that are not `size` distinct candidates,
    requests never answered, and the widest logit gap over a sample of
    answered requests drawn from the seed. With `served_logits` (weights
    and feature columns -> the logits of every row) the served lists are
    ranked from those logits instead of read from `rows`: the control."""
    cfg, tr = ctx.config, ctx.traffic
    cat = Catalog(os.path.join(ctx.root, cfg["data_root"]))
    cands = cat.candidates()
    index = {m: i for i, m in enumerate(cands)}
    size = tr["size"]
    bad = unanswered = 0
    answered = []
    for (k, _, user), r in zip(requests, rows):
        if served_logits is not None:
            answered.append((user, None))
            continue
        if r[2] is None or r[3] != 200:
            unanswered += r[3] != 503
            continue
        ids = r[4]
        if (ids is None or len(ids) != min(size, len(cands)) or len(set(ids)) != len(ids)
                or any(m not in index for m in ids)):
            bad += 1
            continue
        answered.append((user, ids))
    rng = np.random.default_rng(weights.sub_seed(ctx.seed, 4))
    pick = rng.choice(len(answered), size=min(CHECK_SAMPLE, len(answered)), replace=False)
    sample = [answered[i] for i in sorted(pick)]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = weights.make_din(cfg, ctx.seed, ctx.device)
    gap = 0.0
    block = 64
    for i in range(0, len(sample), block):
        part = sample[i:i + block]
        users = [u for u, _ in part]
        cols = cat.request_columns(users, cands)
        feats = {c: torch.from_numpy(v).to(ctx.device) for c, v in cols.items()}
        logits = ref.logits_in_blocks(w, feats, cfg["recent_movies"],
                                      ref.DTYPES[cfg["compute_dtype"]])
        logits = logits.view(len(part), len(cands)).double().cpu().numpy()
        if served_logits is not None:
            ctrl = served_logits(w, feats).view(len(part), len(cands)).double().cpu().numpy()
            lists = [[cands[j] for j in np.argsort(-ctrl[r], kind="stable")[:size]]
                     for r in range(len(part))]
        else:
            lists = [ids for _, ids in part]
        for r, ids in enumerate(lists):
            best = np.sort(logits[r])[::-1][:len(ids)]
            got = logits[r][[index[m] for m in ids]]
            gap = max(gap, float(np.max(best - got)))
    return {"bad_lists": float(bad), "unanswered": float(unanswered), "rank_gap": gap,
            "sampled": len(sample)}


def compare(ctx: harness.Context, requests, rows):
    got = served_gaps(ctx, requests, rows)
    limits = harness.limits_of(ctx.root, ctx.cell["name"])
    return [harness.Check(k, got[k], limits[k]) for k in ("bad_lists", "unanswered", "rank_gap")]

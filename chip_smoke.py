#!/usr/bin/env python3
"""Drive the PyTorch port (`sparrowrecsys_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. device: the card's name and power limit (nvidia-smi); TF32 off.
2. build: compile the hand-written kernels (csrc/*.cu) with nvcc.
3. kernels: each kernel against its plain PyTorch version on the card,
   at the serving path's shapes and at the large shapes of KERNELS.md,
   timed with CUDA events, and by torch.profiler for the device's own
   time, beside its bound; each timed call reads inputs that are not in
   L2.
4. serving: the DIN and DeepFMv2 exports behind the port's HTTP server
   on the card; the five endpoints and 2 x RANKED_REQUESTS concurrent
   ranked requests over HTTP (several seconds), with the kernels' launch
   counts read around that run; the
   card's wave scores against the same scorers on the CPU; one wave's
   wall time beside its model forward alone, and the device's busy time
   and idle share over a profiled run of waves (torch.profiler).
5. summary: one {"kernels": [...]} line, then the last line,
   {"ok": true, "device": {...}}.

Without CUDA, or without the package beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
#: H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s and float32 FLOP/s
#: outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
#: The H100's L2 (50 MB). A timed kernel cycles through copies of its
#: inputs that span four times this, so each call reads from HBM, as the
#: bound assumes, and not from the copy the call before left in L2.
L2_BYTES = 50 * 2 ** 20
#: The serving path's launch shapes: 8 requests x 800 candidates padded
#: to 8192 rows per wave; DeepFMv2 5 fields of 64, DIN T=5, D=10, H=32.
WAVE_ROWS = 8192
#: Users whose ranked requests phase 4 sends (cycled), ranked requests per
#: model, and how many run at once.
RANKED_USERS = 64
RANKED_REQUESTS = 2048
CONCURRENCY = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, iters: int) -> float:
    """Mean ms of `fn()` over `iters` runs after warm-up, by CUDA events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(prof) -> dict:
    """Summed duration in us of each device operation (kernel or copy)
    that `prof` (a finished torch.profiler run) recorded, by name, and
    their number under the key None."""
    from torch.autograd import DeviceType

    out = {None: 0}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us()
            out[None] += 1
    return out


def device_ms(fn, iters: int, marker: str = ""):
    """Mean device time per call of `fn()` under torch.profiler: the
    device operations whose name holds `marker`. Back-to-back CUDA events
    read the host's launch rate for a kernel of a few microseconds; this
    reads the device's own time. None when no such operation ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [v for k, v in device_us(prof).items() if k is not None and marker in k]
    return sum(us) / 1e3 / iters if us else None


def cycling(inputs, nbytes: int):
    """A function that returns, call after call, `inputs` and copies of it
    (each a tuple of tensors of `nbytes` in all), enough copies to span
    4 x L2_BYTES."""
    import torch

    copies = max(1, math.ceil(4 * L2_BYTES / nbytes))
    sets = [inputs] + [tuple(torch.clone(a) for a in inputs) for _ in range(copies - 1)]
    return itertools.cycle(sets).__next__


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---- phase 3 -----------------------------------------------------------------


def check_fm_cross(shape, dtype, iters):
    import torch

    from sparrowrecsys_torch.ops.fm import fm_cross, fm_cross_plain

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    out, ref = fm_cross(x), fm_cross_plain(x)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    # float32: summation order and one fma differ, 1e-5 of the output's
    # scale; bfloat16: one rounding of the output, 1e-2 of its scale.
    tol = (1e-5 if dtype == torch.float32 else 1e-2) * scale
    if not err <= tol:
        raise AssertionError(f"fm_cross {shape} {dtype}: max err {err} > {tol}")
    b, f, d = shape
    size = x.element_size()
    nbytes, flops = (b * f * d + b * d) * size, 3 * b * f * d + 2 * b * d
    t_bound, by = bound(nbytes, flops)
    nxt = cycling((x,), x.numel() * size)
    row = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": err, "tol": tol,
           "ms": timed(lambda: fm_cross(*nxt()), iters),
           "plain_ms": timed(lambda: fm_cross_plain(*nxt()), iters),
           "bound_ms": t_bound, "bound_by": by, "library_ms": None,
           "device_ms": device_ms(lambda: fm_cross(*nxt()), iters, "fm_cross_kernel"),
           "plain_device_ms": device_ms(lambda: fm_cross_plain(*nxt()), iters)}
    log(f"[kernels] fm_cross {json.dumps(row)}")
    return row


def check_din_attention(b, t, d, h, iters):
    import torch

    from sparrowrecsys_torch.ops.attention import din_attention, din_attention_plain

    g = torch.Generator(device="cuda").manual_seed(1)
    hist = torch.randn(b, t, d, generator=g, device="cuda")
    # Padded history steps are all-zero rows (mask_zero); about a third.
    pad = torch.rand(b, t, 1, generator=g, device="cuda") < 0.3
    hist = hist.masked_fill(pad, 0.0).contiguous()
    cand = torch.randn(b, d, generator=g, device="cuda")
    w1 = torch.randn(4 * d, h, generator=g, device="cuda") / (4 * d) ** 0.5
    b1 = torch.randn(h, generator=g, device="cuda") * 0.1
    alpha = torch.randn(h, generator=g, device="cuda") * 0.1
    w2 = torch.randn(h, 1, generator=g, device="cuda") / h ** 0.5
    b2 = torch.randn(1, generator=g, device="cuda") * 0.1
    args = (hist, cand, w1, b1, alpha, w2, b2)
    out, ref = din_attention(*args), din_attention_plain(*args)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    # float32 with another summation order (cuBLAS in the plain version):
    # 1e-5 relative, and 1e-5 of the output's scale absolute.
    tol_ok = torch.allclose(out, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())
    if not tol_ok:
        raise AssertionError(f"din_attention {(b, t, d, h)}: max err {err}")
    nbytes = (b * t * d + b * d + 4 * d * h + 3 * h + 1 + b * d) * 4
    # The candidate's share c @ (wc-wa) + b1 is one [D, H] product per
    # row; each step adds h @ (wa+wb) + (h*c) @ wd, H for the second
    # layer. An all-zero step gets weight 0 whatever the unit computes, so
    # the work this data needs is the step part over the non-zero steps.
    live_steps = int((hist != 0).any(dim=-1).sum().item())
    flops = 2 * (live_steps * (2 * d * h + h) + b * d * h)
    t_bound, by = bound(nbytes, flops)
    nxt = cycling((hist, cand), (b * t * d + b * d) * 4)
    weights = args[2:]
    row = {"shape": [b, t, d, h], "dtype": "float32", "max_abs_err": err,
           "ms": timed(lambda: din_attention(*nxt(), *weights), iters),
           "plain_ms": timed(lambda: din_attention_plain(*nxt(), *weights), iters),
           "bound_ms": t_bound, "bound_by": by, "library_ms": None,
           "device_ms": device_ms(lambda: din_attention(*nxt(), *weights), iters,
                                  "din_attention_kernel"),
           "plain_device_ms": device_ms(lambda: din_attention_plain(*nxt(), *weights), iters)}
    log(f"[kernels] din_attention {json.dumps(row)}")
    return row


# ---- phase 4 -----------------------------------------------------------------


def fm_logit_noise(fields, w_out):
    """Float32 rounding noise the FM cross puts into each logit, [B], from
    the fields [B, F, D] and the output layer's FM weights [D].

    With raw numerics (releaseYear near 2000) one field is in the
    hundreds, and (sum x)^2 - sum x^2 cancels terms near 1e5: each element
    carries roundings of size u ((sum_f |x_f|)^2 + sum_f x_f^2),
    u = 2**-24. Two float32 evaluations (the card and the CPU) differ by
    about this much: two roundings per element, added over D with random
    signs (root-sum-square), weighted by the output layer."""
    import numpy as np

    x = np.asarray(fields, np.float64)
    size = np.abs(x).sum(1) ** 2 + (x * x).sum(1)
    return 2 * 2.0 ** -24 * np.sqrt(((size * np.abs(w_out)) ** 2).sum(1))


def _get(url: str):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, r.read()


def serving_phase(device: str = "cuda"):
    """Returns (launch counts during the HTTP run, requests/s, parity)."""
    import numpy as np
    import torch

    from sparrowrecsys_torch.config import DataConfig, ServingConfig
    from sparrowrecsys_torch.models import build_model
    from sparrowrecsys_torch.ops.attention import din_attention
    from sparrowrecsys_torch.ops.fm import fm_cross
    from sparrowrecsys_torch.serving.assembler import FeatureAssembler
    from sparrowrecsys_torch.serving.feature_store import FeatureStore
    from sparrowrecsys_torch.serving.rankers import ModelScorer
    from sparrowrecsys_torch.serving.server import RecSysServer, load_catalog

    data = DataConfig(data_root=os.path.join(REPO, "data"))
    dm = load_catalog(data)
    asm = FeatureAssembler(FeatureStore.load(data.path("feature_store.json")), dm)
    models = ("din", "deepfm_v2")

    def scorers(device):
        return {m: ModelScorer.from_checkpoint(
            build_model(m), data.path(f"modeldata/{m}"), asm, device=device) for m in models}

    server = RecSysServer(dm, ServingConfig(port=0, model_poll_s=0),
                          scorers=scorers(device), device=device)
    server.start()
    try:
        t0 = time.perf_counter()
        server.warmup()
        log(f"[serving] warmup {time.perf_counter() - t0:.3f} s")
        base = f"http://localhost:{server.port}"
        with open(data.path("ratings.csv")) as f:
            next(f)
            users = list(dict.fromkeys(int(line.split(",")[0]) for line in f))[:RANKED_USERS]

        fm_cross.launches = 0
        din_attention.launches = 0
        for path in ("/getmovie?id=1", f"/getuser?id={users[0]}",
                     "/getrecommendation?genre=Action&size=8&sortby=rating",
                     "/getsimilarmovie?movieId=1&size=16&model=emb",
                     f"/getrecforyou?id={users[0]}&size=32&model=emb"):
            status, body = _get(base + path)
            if status != 200 or not body:
                raise AssertionError(f"{path}: status {status}, {len(body)} bytes")
            json.loads(body)
        ranked = [f"{base}/getrecforyou?id={u}&size=32&model={m}"
                  for u in itertools.islice(itertools.cycle(users), RANKED_REQUESTS)
                  for m in models]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(CONCURRENCY) as pool:
            results = list(pool.map(_get, ranked))
        wall = time.perf_counter() - t0
        counts = {"fm_cross": fm_cross.launches, "din_attention": din_attention.launches}
        for url, (status, body) in zip(ranked, results):
            movies = json.loads(body)
            if status != 200 or len(movies) != 32 or not all("movieId" in m for m in movies):
                raise AssertionError(f"{url}: status {status}, {len(movies)} movies")
        _, body = _get(base + "/metrics")
        waves = {m: json.loads(body)["batchers"][m] for m in models}
        # A smoke reading of the host-bound serving rate over the whole
        # window, not a benchmark: one client process on the server's host.
        log(f"[serving] {len(ranked)} ranked requests in {wall:.3f} s = "
            f"{len(ranked) / wall:.1f} req/s over the whole window, concurrency "
            f"{CONCURRENCY}; waves {json.dumps(waves)}")
        log(f"[serving] kernel launches during the HTTP run: {json.dumps(counts)}")
        for name, n in counts.items():
            if n <= 0:
                raise AssertionError(f"{name} was not launched by the serving path")

        # The device's wave scores against the same exports on the CPU.
        cands, _ = server.rec_for_you._candidate_set()
        cand_ids = [c.movie_id for c in cands]
        k = server.rec_for_you.model_batch
        wave_users = users[:k]
        cpu = scorers("cpu")
        parity = {}
        for m in models:
            gpu_s = server.rec_for_you.scorers[m]
            gpu_s.prepare_wave(cand_ids, k)
            cpu[m].prepare_wave(cand_ids, k)
            got, ref = gpu_s.score_wave(wave_users), cpu[m].score_wave(wave_users)
            if got.shape != (k, len(cand_ids)) or not np.isfinite(got).all():
                raise AssertionError(f"{m}: wave scores {got.shape}, finite {np.isfinite(got).all()}")
            # 2.5e-5: the exports' float32 logit noise (1e-4 with raw
            # numerics) times the sigmoid's slope of 1/4; DeepFMv2 adds
            # twice its FM cross's rounding noise, from the CPU scorer's
            # fields (fm_logit_noise).
            tol = np.full(got.shape, 2.5e-5)
            if m == "deepfm_v2":
                model = cpu[m].model
                w_out = model.out.weight[0, 1:1 + model.proj_item.out_features].detach().numpy()
                noise = []
                for u in wave_users:
                    feats = cpu[m]._host_batch(asm.features(u, cand_ids), len(cand_ids))
                    with torch.inference_mode():
                        _, fields = model.fields(feats)
                    noise.append(fm_logit_noise(fields[: len(cand_ids)].numpy(), w_out))
                tol = tol + 2 * 0.25 * np.stack(noise)
            err = np.abs(got - ref)
            if not np.all(err <= tol):
                raise AssertionError(f"{m}: cuda vs cpu wave scores differ by {err.max()}")
            parity[m] = {"max_abs_err": float(err.max()), "max_tol": float(tol.max())}
        log(f"[serving] cuda vs cpu wave scores: {json.dumps(parity)}")
        if device == "cuda":
            breakdown = wave_breakdown(server, asm, cand_ids, wave_users)
            log(f"[serving] wave breakdown: {json.dumps(breakdown)}")
        return counts, len(ranked) / wall, parity
    finally:
        server.stop()


def wave_breakdown(server, asm, cand_ids, wave_users, iters: int = 20):
    """Per model, one [k x 800] wave: `score_wave`'s wall time (host
    feature rows, upload, forward, download; host clock, each call ends in
    a copy to the host) beside the model forward alone on the same rows
    already on the card (CUDA events, back to back)."""
    import numpy as np

    out = {}
    mids = np.asarray(cand_ids, np.int32)
    for m, scorer in server.rec_for_you.scorers.items():
        scorer.score_wave(wave_users)
        t0 = time.perf_counter()
        for _ in range(iters):
            scorer.score_wave(wave_users)
        wave_ms = (time.perf_counter() - t0) * 1e3 / iters
        cols = [asm.features(u, mids) for u in wave_users]
        feats = scorer._host_batch({c: np.concatenate([r[c] for r in cols]) for c in cols[0]},
                                   len(wave_users) * len(mids))
        out[m] = {"rows": len(wave_users) * len(mids),
                  "padded_rows": int(next(iter(feats.values())).shape[0]),
                  "score_wave_ms": wave_ms,
                  "forward_ms": timed(lambda: scorer._probs(feats), iters),
                  **profile_waves(scorer, wave_users, iters)}
    return out


def profile_waves(scorer, wave_users, iters: int):
    """`torch.profiler` over `iters` calls of `score_wave`: the device's
    busy time per wave (its kernels and copies, which run on one stream
    and so do not overlap), the idle share of the wave's wall time under
    the profiler, and the device operations that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            scorer.score_wave(wave_users)
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    us = device_us(prof)
    ops = us.pop(None)
    busy_ms = sum(us.values()) / 1e3 / iters
    top = sorted(us.items(), key=lambda kv: -kv[1])[:8]
    return {"profiled_wave_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
            "device_ops_per_wave": ops / iters,
            "port_kernels_ms": {k: sum(v for n, v in us.items() if f"{k}_kernel" in n)
                                / 1e3 / iters for k in ("fm_cross", "din_attention")},
            "top_device_ms": [[name[:80], v / 1e3 / iters] for name, v in top]}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from sparrowrecsys_torch.ops import kernels
    except ImportError:
        print("chip_smoke: sparrowrecsys_torch is not beside this script", file=sys.stderr)
        return 2

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    kernels.library()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.3f} s "
        f"(nvcc {kernels.build_seconds} s)")
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    # 3. kernels against their plain versions
    fm_rows = [
        check_fm_cross((WAVE_ROWS, 5, 64), torch.float32, 200),
        check_fm_cross((262144, 5, 128), torch.float32, 50),
        check_fm_cross((262144, 5, 128), torch.bfloat16, 50),
    ]
    din_rows = [
        check_din_attention(WAVE_ROWS, 5, 10, 32, 200),
        check_din_attention(65536, 64, 128, 32, 10),
    ]
    torch.cuda.empty_cache()

    # 4. serving end to end
    counts, _, _ = serving_phase()

    # 5. summary
    def entry(name, route, source, replaces, rows):
        main_row = rows[0]
        return {
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"], "device_ms": main_row["device_ms"],
            "plain_device_ms": main_row["plain_device_ms"], "shape": main_row["shape"],
            "other_shapes": rows[1:],
        }

    summary = {"kernels": [
        entry("fm_cross", "cuda", "sparrowrecsys_torch/csrc/fm_cross.cu",
              "sparrowrecsys_tpu/ops/fm.py:41", fm_rows),
        entry("din_attention", "cuda", "sparrowrecsys_torch/csrc/din_attention.cu",
              "sparrowrecsys_tpu/ops/attention.py:73", din_rows),
    ]}
    log(json.dumps(summary))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

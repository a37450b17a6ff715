#!/usr/bin/env python3
"""Drive the PyTorch port (`sparrowrecsys_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. device: the card's name and power limit (nvidia-smi); TF32 off.
2. build: compile the hand-written kernels (csrc/*.cu) with nvcc.
3. kernels: each of the six kernels (fm_cross and din_attention with
   their backwards, rows_gather, rows_write) against its plain PyTorch
   version on the card, at the serving or training path's shapes and at
   the large shapes of KERNELS.md, timed with CUDA events, and by
   torch.profiler for the device's own time, beside its bound and, for
   the row kernels, the PyTorch call computing the same function; each
   timed call reads inputs that are not in L2 (the row kernels at
   [2^21, D]: a new id set each call, `row_sets`). The row kernels run
   at the six row calls the DeepFMv2 trainer makes per step, kernel and
   library call timed in turns, and their wrappers' host time is taken
   part by part (`host_path`). The DIN backward's device time is the
   whole call's: its per-step kernel, the reduce and the weight-gradient
   products (cuBLAS), with the kernel's own time, the products' share,
   and the products alone beside one torch.mm each.
4. serving: the DIN and DeepFMv2 exports behind the port's HTTP server
   on the card; the five endpoints and 2 x RANKED_REQUESTS concurrent
   ranked requests over HTTP (several seconds), with the kernels' launch
   counts read around that run; then ZOO_REQUESTS ranked requests for
   each of the other five exports on the same server (EmbeddingMLP,
   Wide&Deep, the NeuralCF two-tower and DIEN as named scorers, NeuralCF
   as the id-only scorer at ?model=neuralcf); each model's
   card wave scores against the same scorers on the CPU; one wave's
   wall time beside its model forward alone, and the device's busy time
   and idle share over a profiled run of waves (torch.profiler).
5. training: all eight zoo models at the shipped widths, batch 65536, on
   synthetic data with a planted signal (DIEN with its negative columns
   and `dien_loss_fn`, DeepFMv2's user and movie tables and DIEN's user
   table on the lazy row-Adam): one step's loss and gradients card
   against CPU; Trainer.fit for 2 epochs of 8 steps (the loss falls, the
   last AUC beats 0.5, examples/s) with the launch counters read around
   it, held against the same fit on the CPU (per-epoch loss and AUC,
   each parameter's drift); one step's forward/backward/optimizer ms and
   the device's busy time and idle share. Then the hand-off:
   `training.run` exports a DeepFMv2 and a DIEN on the card, and the
   serving scorer ranks a wave with each export.
6. offline plane: the feature job (`data.run`) rewrites the bundled
   training and test CSVs byte for byte and a feature-store hand-off the
   port's store loads, and `build_samples` is timed over 1,000,000
   synthetic events; a DeepFMv2 fit with both tables on the row-Adam
   (batch 65536, 2 x 8 steps) interrupted after one epoch and resumed
   from its train state in a fresh Trainer lands on the uninterrupted
   fit (bit for bit, or within twice the distance between two
   uninterrupted fits; the three fits run under PyTorch's deterministic
   algorithms), with the four kernels' launches read around the
   resumed fit; DeepFM with bfloat16 tables, float32 masters and
   bfloat16 moments on the card against the CPU, and the dtype a
   DeepFMv2 with bfloat16 tables hands `fm_cross`; then `training.run`
   trains a DeepFMv2 on the job's CSVs into a state dir, resumes it for a
   second epoch, exports, and the serving scorer ranks a wave with it.
7. candidate generation (`[cands]` lines, no kernel of its own): item2vec
   on the bundled ratings against the CPU replaying the card's draws and
   findSynonyms(158) on both; item2vec over SyntheticSpec()'s 1,000,000
   events (pairs/s, two runs compared bit for bit, the planted-structure
   quality beside the JAX package's) and a planted-signal run at 300,000
   events; DeepWalk's dense walker on the bundled graph and CSR walker on
   the synthetic one (every step on an edge, card = CPU on one draw,
   walks/s) and the graph embedding's SGNS; `embedding.run` on the card
   into a temporary data root that the port's server then serves the
   `emb` paths from; ALS card against CPU on the bundled 80/20 split
   (ms/iteration, recommendations) and chunked against direct sums at
   1,000,000 events; the retrieval trainer card against CPU, then
   `tools.recall_eval` on the card beside recall.json; prepared top-k at
   Q=256, D=64, k=10 over 100,000 and 1,000,000 items (float32 and
   bfloat16).
8. the rest of the system (`[rest]` lines, no kernel of its own):
   `build_samples_device` equal to the host's `build_samples` on every
   column and dtype on the bundled ratings and on phase 6's 1,000,000
   synthetic events (device columns by CUDA events, the host recompute
   and the host pipeline in ms); `device_feature_columns` alone at
   20,000,000 events (MovieLens-20M's count; cut to what phase 6's rate
   makes in 30 s, if that is less), chunked genre stage against the
   direct one bit for bit, its peak memory; events at the shipped widths
   (30,000 users, 1,000 movies, 1,000,000 events) encoded on the card
   and a DeepFMv2 fit on those tensors, which stay on the card with no
   room for a host copy (batch 65536, 2 epochs, both tables on the
   row-Adam; the loss falls, the four kernels' launches
   read around it, examples/s from the fit and from `utils.StepTimer`);
   the TF-Serving sidecar over a DeepFMv2 scorer on the card
   (`RestScorer` scores bit-equal to the in-process ones, requests/s, a
   new export served within two polls); the port's server ranking with
   DIN while a nearline stream tails a ratings file into its catalog (a
   streamed positive rating reaches the next ranked request: staleness
   in s); the webroot's pages, a poster and two refused paths; and
   `utils.trace` around five waves (a Chrome trace with the card's
   kernels).
9. the multi-device plane (`[mesh]` lines): (a) DeepFMv2 (sparse user
   table) and DIN with a 1x1 mesh plan, in this process and under a NCCL
   process group of world size 1, each bit-equal to two fits without a
   plan (batch 65536, 2 epochs of 4 steps, deterministic algorithms),
   with examples/s with and without the plan and `measure_scaling([1])`;
   (b) four ranks on this one card (a 2x2 mesh over gloo, every table
   of at least 16 rows row-sharded) fitting DeepFMv2, DIN and DIEN, each
   within `tests/test_sharded_training.py`'s bounds of the single-card
   fit (a correctness run, no speed); (c) `sharded_cosine_topk` over the
   two model ranks at Q=256, D=64, k=10 over 1,000,000 items, raw and
   prepared, with the single card's indices. Every kernel must launch.
10. summary: one {"kernels": [...]} line (each kernel's launches, phase
   9's among them under `launches_mesh`), then the last line,
   {"ok": true, "device": {...}}.

Without CUDA, or without the package beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
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
#: The training phase's batch (bench.py's) and steps per epoch.
TRAIN_BATCH = 65536
TRAIN_STEPS = 8
#: Users whose ranked requests phase 4 sends (cycled), ranked requests per
#: model, and how many run at once.
RANKED_USERS = 64
RANKED_REQUESTS = 2048
CONCURRENCY = 16
#: The models whose kernels the serving path launches (2 x RANKED_REQUESTS
#: ranked requests), and the rest of the zoo (ZOO_REQUESTS each; NeuralCF,
#: last, through the id-only scorer).
KERNEL_MODELS = ("din", "deepfm_v2")
ZOO_MODELS = ("embedding_mlp", "wide_deep", "neuralcf_two_tower", "dien", "neuralcf")
ZOO_REQUESTS = 256


def log(msg: str) -> None:
    print(msg, flush=True)


def event_ms(fn, device: str = "cuda"):
    """(fn(), ms) of one run between two CUDA events (the host clock on
    the CPU)."""
    import torch

    if device != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def timed(fn, iters: int) -> float:
    """Mean ms of `fn()` over `iters` runs after warm-up, by CUDA events."""
    for _ in range(3):
        fn()

    def runs():
        for _ in range(iters):
            fn()

    return event_ms(runs)[1] / iters


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


def in_turns(fns: dict, measure, rounds: int = 8) -> dict:
    """{name: (median, least, most)} of `measure(fn)` over `rounds` rounds
    for each of `fns`, taken in turns with the order reversed every other
    round (a b, b a, ...), so that a drift in the host's speed falls on
    each alike. Back-to-back CUDA events on a kernel of a few
    microseconds read the host's rate, which moves by a third between
    runs on a host shared with other work."""
    got = {k: [] for k in fns}
    for r in range(rounds):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            got[k].append(measure(fns[k]))
    return {k: (statistics.median(v), min(v), max(v)) for k, v in got.items()}


def host_us(fn, iters: int = 2000) -> float:
    """Host microseconds per call of `fn()`: `time.perf_counter` over
    `iters` calls with no synchronisation in between. A launch queues in
    about the time the device takes to run a row kernel, so the queue
    does not fill and this reads what the host spends on a call."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def host_path():
    """The row wrappers' host time per call, whole and part by part, at
    the trainer's shape (DeepFMv2's fused user buffer [30001, 30] f32, the
    touched ids of one synthetic batch as the row-Adam routes them): the
    whole call, the input checks (`rowio._check`), the lookup of the
    launch's scalars, a ctypes call of each entry point with the real
    pointers and the scalars of U = 0 (the C side returns before it reads
    the device or launches) and with the real scalars (the launch
    alone), and the PyTorch calls computing the same functions. In us,
    host clock."""
    import torch

    from sparrowrecsys_torch.data.synthetic import synthetic_ctr_dataset
    from sparrowrecsys_torch.ops import kernels, rowio
    from sparrowrecsys_torch.training.row_optim import _touched_rows

    users = torch.from_numpy(synthetic_ctr_dataset(TRAIN_BATCH, seed=11).features["userId"])
    uids, safe = _touched_rows(users.cuda(), 30001)
    table = torch.randn(30001, 30, device="cuda")
    rows = torch.randn(TRAIN_BATCH, 30, device="cuda")
    lib = kernels.library()
    idx = table.get_device()
    valid = uids < table.shape[0]
    safe_long, valid_ids, valid_rows = safe.long(), uids[valid].long(), rows[valid]
    stream = kernels.stream_of(idx)
    out = {}
    for kind, args in (("rows_gather", (table, safe)), ("rows_write", (table, uids, rows))):
        entry = getattr(lib, kind)
        ptrs = (table.data_ptr(), args[1].data_ptr(), rows.data_ptr())
        misalign = (ptrs[0] | ptrs[2]) & 15
        scalars = rowio._scalars(120, misalign, TRAIN_BATCH, table.shape[0], idx)
        empty = rowio._scalars(120, misalign, 0, table.shape[0], idx)
        out[kind] = {
            "call": host_us(lambda: getattr(rowio, kind)(*args)),
            "check": host_us(lambda: rowio._check(kind, idx, *args)),
            "scalars": host_us(
                lambda: rowio._scalars(120, misalign, TRAIN_BATCH, table.shape[0], idx)),
            "ctypes_empty_launch": host_us(lambda: entry(*ptrs, empty, stream)),
            "ctypes_launch": host_us(lambda: entry(*ptrs, scalars, stream)),
        }
    out["library_calls"] = {
        "index_select": host_us(lambda: torch.index_select(table, 0, safe_long)),
        "index_copy_": host_us(lambda: table.index_copy_(0, valid_ids, valid_rows)),
    }
    log(f"[kernels] host path, us per call: {json.dumps(out)}")
    return out


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


def live_counts(hist):
    """(live steps, rows with a live step) of a DIN history [B, T, D]: a
    step is live when its row has a non-zero element."""
    live = (hist != 0).any(dim=-1)
    return int(live.sum().item()), int(live.any(dim=-1).sum().item())


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
    # the work this data needs is the step part over the non-zero steps,
    # and the row part over the rows with one.
    live_steps, live_rows = live_counts(hist)
    flops = 2 * (live_steps * (2 * d * h + h) + live_rows * d * h)
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


def fm_bwd_tolerance(x, g, ref):
    """Per element of dx = 2 g (s - x_f), what two correct evaluations may
    differ by: float32 roundings of s and of the products, a few float32
    ulps of the terms summed (2^-20 * 2|g| * sum_f |x_f|); in bfloat16
    also one rounding of dx, one bf16 ulp (2^-7 |dx|). A sum s kept in
    bfloat16 is off by bf16 ulps of |s| and fails it
    (`fm_cross_bwd_bf16_sum`)."""
    import torch

    tol = 2.0 ** -20 * 2 * g.float().abs()[:, None, :] * x.float().abs().sum(1, keepdim=True)
    if x.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * ref.float().abs()
    return tol


def fm_cross_bwd_bf16_sum(x, g):
    """dx with s summed in bfloat16: the precision fault the kernel must
    not have, to show the tolerance catches it."""
    s = x[:, 0]
    for f in range(1, x.shape[1]):
        s = s + x[:, f]                                   # bf16 + bf16 -> bf16
    return (2 * g.float()[:, None, :] * (s.float()[:, None, :] - x.float())).to(x.dtype)


def check_fm_cross_bwd(shape, dtype, iters):
    import torch

    from sparrowrecsys_torch.ops.fm import fm_cross_bwd, fm_cross_bwd_plain

    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    go = torch.randn((shape[0], shape[2]), generator=g, device="cuda").to(dtype)
    out, ref = fm_cross_bwd(x, go), fm_cross_bwd_plain(x, go)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    tol = fm_bwd_tolerance(x, go, ref)
    if not bool((diff <= tol).all()):
        raise AssertionError(f"fm_cross_bwd {shape} {dtype}: max err {err}, "
                             f"{int((diff > tol).sum())} elements beyond the tolerance")
    # The largest share of its own tolerance an element uses.
    extra = {"err_over_tol_max": (diff / tol.clamp_min(1e-30)).max().item()}
    if dtype == torch.bfloat16:
        over = int(((fm_cross_bwd_bf16_sum(x, go).float() - ref.float()).abs() > tol).sum())
        if over == 0:
            raise AssertionError("fm_cross_bwd: the tolerance passes a sum kept in bfloat16")
        extra["bf16_sum_elements_beyond_tol"] = over
    del diff, tol
    b, f, d = shape
    size = x.element_size()
    # Bytes: read x and g, write dx. Operations: F adds per column for s,
    # then a subtract and a multiply per element (2g once per column).
    nbytes, flops = (2 * b * f * d + b * d) * size, 3 * b * f * d + b * d
    t_bound, by = bound(nbytes, flops)
    nxt = cycling((x, go), (x.numel() + go.numel()) * size)
    row = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": err, **extra,
           "ms": timed(lambda: fm_cross_bwd(*nxt()), iters),
           "plain_ms": timed(lambda: fm_cross_bwd_plain(*nxt()), iters),
           "bound_ms": t_bound, "bound_by": by, "library_ms": None,
           "device_ms": device_ms(lambda: fm_cross_bwd(*nxt()), iters, "fm_cross_bwd_kernel"),
           "plain_device_ms": device_ms(lambda: fm_cross_bwd_plain(*nxt()), iters)}
    log(f"[kernels] fm_cross_bwd {json.dumps(row)}")
    return row


def unit_preactivations(hist, cand, w1, b1):
    """The DIN unit's pre-activations [B, T, H]: [h, c, h*c] @ the folded
    weight + b1, as the plain version computes them."""
    import torch

    from sparrowrecsys_torch.ops.attention import _fold

    ce = cand[:, None, :].expand_as(hist)
    return torch.cat([hist, ce, hist * ce], -1) @ _fold(w1, hist.shape[-1]) + b1


def din_bwd_flops(d, h, live_steps, live_rows):
    """Operations of the DIN unit's backward for this data, each multiply-
    add counted once as two operations. Per live step: the recompute
    (2*D*H + H), dh through the folded weight's wa+wb and wd blocks
    (2*D*H), and the weight gradients dk0 = h^T dapre, dk2 = (h*c)^T dapre
    (2*D*H), db1, dalpha, dw2 (3*H). Per row with a live step, on
    sum_t dapre_t (the candidate's terms see the step only through dapre):
    the candidate term of the recompute, dc's (wc-wa) dapre and
    dk1 = c^T dapre (D*H each). A masked step needs none of it:
    2 * (live_steps * (6*D*H + 4*H) + live_rows * 3*D*H)."""
    return 2 * (live_steps * (6 * d * h + 4 * h) + live_rows * 3 * d * h)


def check_din_attention_bwd(b, t, d, h, iters):
    import torch

    from sparrowrecsys_torch.ops.attention import (
        _din_attention_bwd_steps,
        _din_weight_grads,
        _tn,
        din_attention_bwd,
        din_attention_bwd_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(1)
    hist = torch.randn(b, t, d, generator=g, device="cuda")
    pad = torch.rand(b, t, 1, generator=g, device="cuda") < 0.3
    hist = hist.masked_fill(pad, 0.0).contiguous()
    cand = torch.randn(b, d, generator=g, device="cuda")
    w1 = torch.randn(4 * d, h, generator=g, device="cuda") / (4 * d) ** 0.5
    b1 = torch.randn(h, generator=g, device="cuda") * 0.1
    alpha = torch.randn(h, generator=g, device="cuda") * 0.1
    w2 = torch.randn(h, 1, generator=g, device="cuda") / h ** 0.5
    b2 = torch.randn(1, generator=g, device="cuda") * 0.1
    go = torch.randn(b, d, generator=g, device="cuda")
    weights = (w1, b1, alpha, w2, b2)
    # The PReLU's kink: where a pre-activation lies within rounding of 0
    # (|a| < 1e-3; the kernel's and cuBLAS's sums differ by about 1e-5 at
    # D=128), the two may take different branches. That step's gradients
    # then differ by (1 - alpha) * da, a true discontinuity and not an
    # error: its dh, its row's dc, and through the step's share every
    # weight gradient (by up to |h| (1 - alpha) |w2 dl|, about 0.3 at
    # D=128). Those steps alone are zeroed in the history and counted:
    # they become masked steps, the other steps' pre-activations do not
    # depend on them, and every other step is compared in every gradient.
    kink = (unit_preactivations(hist, cand, w1, b1).abs() < 1e-3).any(-1) \
        & (hist != 0).any(-1)                                         # [B, T]
    kink_steps = int(kink.sum().item())
    hist = hist.masked_fill(kink[..., None], 0.0).contiguous()
    del kink
    got = din_attention_bwd(hist, cand, *weights, go)
    ref = din_attention_bwd_plain(hist, cand, *weights, go)
    again = din_attention_bwd(hist, cand, *weights, go)
    torch.cuda.synchronize()
    errs = {}
    for name, x, r, y in zip(("dh", "dc", "dw1", "db1", "dalpha", "dw2", "db2"), got, ref, again):
        # float32 sums over B*T in another order than cuBLAS: 1e-4
        # relative and 1e-4 of the gradient's scale absolute.
        scale = max(r.abs().max().item(), 1.0)
        errs[name] = (x - r).abs().max().item()
        if not torch.allclose(x, r, rtol=1e-4, atol=1e-4 * scale):
            raise AssertionError(f"din_attention_bwd {(b, t, d, h)} {name}: max err {errs[name]}")
        if not torch.equal(x, y):
            raise AssertionError(f"din_attention_bwd {(b, t, d, h)} {name}: two runs differ")
    del got, ref, again
    live_steps, live_rows = live_counts(hist)
    flops = din_bwd_flops(d, h, live_steps, live_rows)
    n_w = 4 * d * h + 3 * h + 1
    nbytes = (2 * (b * t * d + b * d) + b * d + 2 * n_w) * 4
    t_bound, by = bound(nbytes, flops)
    nxt = cycling((hist, cand, go), (b * t * d + 2 * b * d) * 4)

    def call(fn):
        hh, cc, gg = nxt()
        return fn(hh, cc, *weights, gg)

    row = {"shape": [b, t, d, h], "dtype": "float32", "max_abs_err": max(errs.values()),
           "errs": errs, "deterministic": True, "live_steps": live_steps,
           "live_rows": live_rows, "kink_steps_zeroed": kink_steps,
           "kink_share": kink_steps / max(1, live_steps + kink_steps),
           "flops": flops,
           "ms": timed(lambda: call(din_attention_bwd), iters),
           "plain_ms": timed(lambda: call(din_attention_bwd_plain), iters),
           "bound_ms": t_bound, "bound_by": by, "library_ms": None,
           # Every device operation of the call: the per-step kernel, its
           # reduce, and the weight-gradient products (cuBLAS) with their
           # allocations' and reductions' kernels.
           "device_ms": device_ms(lambda: call(din_attention_bwd), iters),
           "kernel_device_ms": device_ms(lambda: call(din_attention_bwd), iters,
                                         "din_attention_bwd"),
           "plain_device_ms": device_ms(lambda: call(din_attention_bwd_plain), iters)}
    row["products_share"] = 1 - row["kernel_device_ms"] / row["device_ms"]
    # The weight-gradient products alone on this call's per-step terms:
    # the wrapper's sliced products, one torch.mm each, and the wrapper's
    # slicing on h and h*c apart (the products if the kernel wrote h*c
    # alone: dapre read twice in place of the copy of h).
    _, _, dapre, hx, dsum, _ = _din_attention_bwd_steps(hist, cand, *weights, go)
    flat, hc = hist.view(-1, d), hx[:, d:].contiguous()
    row["products_device_ms"] = device_ms(lambda: _din_weight_grads(hx, dapre, cand, dsum), iters)
    row["mm_products_device_ms"] = device_ms(
        lambda: (torch.mm(hx.T, dapre), torch.mm(cand.T, dsum)), iters)
    row["split_products_device_ms"] = device_ms(
        lambda: (_tn(flat, dapre), _tn(hc, dapre), _tn(cand, dsum)), iters)
    log(f"[kernels] din_attention_bwd {json.dumps(row)}")
    return row


def row_sets(table, id_sets, rows=None):
    """Input sets for timed row calls, taken in turn, each (table, ids,
    rows or None, in-range ids as int64, their rows): with one id set,
    copies of the table, ids and rows that span 4 x L2_BYTES; with several
    (a table too large to copy), each id set on the one table with a copy
    of the rows, `rows_cases` drawing enough id sets that the rows they
    touch span 4 x L2_BYTES. So no timed call finds its rows in L2."""
    import torch

    def one(t, i, r):
        keep = (i >= 0) & (i < t.shape[0])
        return (t, i, r, i[keep].long(), None if r is None else r[keep])

    if len(id_sets) > 1:
        return [one(table, i, None if rows is None else rows.clone()) for i in id_sets]
    inputs = (table, id_sets[0]) + (() if rows is None else (rows,))
    nbytes = sum(a.numel() * a.element_size() for a in inputs)
    copies = max(1, math.ceil(4 * L2_BYTES / nbytes))
    sets = [inputs] + [tuple(torch.clone(a) for a in inputs) for _ in range(copies - 1)]
    return [one(s[0], s[1], s[2] if rows is not None else None) for s in sets]


def check_rows(kind, table, id_sets, iters, label):
    """rows_gather or rows_write on `table` and the first of `id_sets`
    against the plain version (a row copy is exact: bit-equal), timed over
    `row_sets` beside the bound and one PyTorch call computing the same
    function (`index_select`, or `index_copy_` on the in-range ids), which
    the port never calls: CUDA events and host time per call (`host_us`),
    kernel and library call in turns (`in_turns`, medians), and device
    time under torch.profiler; with the kernel's launch plan."""
    import torch

    from sparrowrecsys_torch.ops import rowio
    from sparrowrecsys_torch.ops.rowio import (
        rows_gather,
        rows_gather_plain,
        rows_write,
        rows_write_plain,
    )

    ids = id_sets[0]
    u, row_bytes = ids.shape[0], table.shape[1] * table.element_size()
    valid = (ids >= 0) & (ids < table.shape[0])
    # The plan, where the package has one (a package from before the
    # launch plan is timed with this yardstick too).
    launch_plan = getattr(rowio, "launch_plan", None)
    if kind == "rows_gather":
        before = rows_gather.launches
        out, ref = rows_gather(table, ids), rows_gather_plain(table, ids)
        launched = rows_gather.launches - before
        ok = torch.equal(out, ref)
        plan = launch_plan and launch_plan(row_bytes, table.data_ptr(), out.data_ptr(), u)
        del out, ref
        # Bytes: read each distinct row once (the trainer's drop slots are
        # all clamped to row V-1) and the U ids, write U rows.
        n_read = int(torch.unique(ids).numel())
        nbytes = (n_read + u) * row_bytes + 4 * u
        sets = row_sets(table, id_sets)

        def kernel():
            t, i, _, _, _ = nxt()
            return rows_gather(t, i)

        def plain():
            t, i, _, _, _ = nxt()
            return rows_gather_plain(t, i)

        def library():
            t, _, _, long_ids, _ = nxt()
            return torch.index_select(t, 0, long_ids)

        marker = "rows_gather_kernel"
    else:
        rows = torch.randn(u, table.shape[1], device="cuda").to(table.dtype)
        before = rows_write.launches
        out = rows_write(table.clone(), ids, rows)
        launched = rows_write.launches - before
        ref = rows_write_plain(table.clone(), ids, rows)
        ok = torch.equal(out, ref)
        plan = launch_plan and launch_plan(row_bytes, table.data_ptr(), rows.data_ptr(), u)
        del out, ref
        n_read = int(valid.sum().item())
        # Bytes: read the in-range rows and every id, write the in-range rows.
        nbytes = 2 * n_read * row_bytes + 4 * u
        sets = row_sets(table, id_sets, rows)

        def kernel():
            t, i, r, _, _ = nxt()
            return rows_write(t, i, r)

        def plain():
            t, i, r, _, _ = nxt()
            return rows_write_plain(t, i, r)

        def library():
            t, _, _, valid_ids, valid_rows = nxt()
            return t.index_copy_(0, valid_ids, valid_rows)

        marker = "rows_write_kernel"
    torch.cuda.synchronize()
    if not ok or launched != 1:
        raise AssertionError(f"{kind} {label}: differs from its plain version or launched "
                             f"{launched} times")
    nxt = itertools.cycle(sets).__next__
    t_bound, by = bound(nbytes, 0)
    pair = {"kernel": kernel, "library": library}
    ms = in_turns(pair, lambda fn: timed(fn, iters))
    us = in_turns(pair, lambda fn: host_us(fn, 500))
    row = {"shape": list(table.shape), "ids": u, "in_range": int(valid.sum().item()),
           "rows_read": n_read, "bytes": nbytes, "input_sets": len(sets),
           "plan": plan and plan._asdict(),
           "dtype": str(table.dtype).replace("torch.", ""), "label": label, "max_abs_err": 0.0,
           "ms": ms["kernel"][0], "plain_ms": timed(plain, iters),
           "bound_ms": t_bound, "bound_by": by, "library_ms": ms["library"][0],
           "ms_range": ms["kernel"][1:], "library_ms_range": ms["library"][1:],
           "device_ms": device_ms(kernel, iters, marker),
           "plain_device_ms": device_ms(plain, iters),
           "library_device_ms": device_ms(library, iters),
           "host_us": us["kernel"][0], "library_host_us": us["library"][0]}
    log(f"[kernels] {kind} {json.dumps(row)}")
    return row


def rows_cases(iters_small, iters_large):
    """Both row kernels at the six calls the trainer makes per step
    (DeepFMv2's lazy row-Adam on its user and movie tables: the [V, 3D]
    buffer gather, the [V, D] gradient gather and the buffer write, with
    the ids of one synthetic batch of 65536 padded and routed as
    `_touched_rows` does) and at the shapes of KERNELS.md ([2^21, 128] and
    [2^21, 384] f32, and [2^21, 128] bf16, 65536 distinct sorted ids, a
    new draw for each timed set until the rows they touch span 4 x
    L2_BYTES)."""
    import torch

    from sparrowrecsys_torch.config import MOVIE_VOCAB_SIZE, USER_VOCAB_SIZE
    from sparrowrecsys_torch.data.synthetic import synthetic_ctr_dataset
    from sparrowrecsys_torch.training.row_optim import _touched_rows

    out = {"rows_gather": [], "rows_write": []}
    feats = synthetic_ctr_dataset(TRAIN_BATCH, seed=11).features
    tables = (("userId", USER_VOCAB_SIZE, "user"), ("movieId", MOVIE_VOCAB_SIZE, "movie"))
    for col, v, name in tables:
        uids, safe = _touched_rows(torch.from_numpy(feats[col]).cuda(), v)
        buf = torch.randn(v, 30, device="cuda")
        grad = torch.randn(v, 10, device="cuda")
        out["rows_gather"].append(check_rows("rows_gather", buf, [safe], iters_small,
                                             f"train {name} buffer"))
        out["rows_write"].append(check_rows("rows_write", buf, [uids], iters_small,
                                            f"train {name} buffer"))
        out["rows_gather"].append(check_rows("rows_gather", grad, [safe], iters_small,
                                             f"train {name} gradient"))
        del buf, grad
        torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(5)
    for width, dtype in ((128, torch.float32), (384, torch.float32), (128, torch.bfloat16)):
        v = 2 ** 21
        table = torch.randn(v, width, generator=g, device="cuda").to(dtype)
        # A call reads and writes 65536 rows.
        touched = 2 * TRAIN_BATCH * width * table.element_size()
        id_sets = [torch.randperm(v, generator=g, device="cuda")[:TRAIN_BATCH].sort().values
                   .to(torch.int32) for _ in range(max(2, math.ceil(4 * L2_BYTES / touched)))]
        for kind in out:
            out[kind].append(check_rows(kind, table, id_sets, iters_large, "kernels_md"))
        del table, id_sets
        torch.cuda.empty_cache()
    return out


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


def _ranked(base, users, models, per_model):
    """`per_model` concurrent ranked requests for each of `models` over
    HTTP, each checked; returns the wall time in s."""
    ranked = [f"{base}/getrecforyou?id={u}&size=32&model={m}"
              for u in itertools.islice(itertools.cycle(users), per_model) for m in models]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(CONCURRENCY) as pool:
        results = list(pool.map(_get, ranked))
    wall = time.perf_counter() - t0
    for url, (status, body) in zip(ranked, results):
        movies = json.loads(body)
        if status != 200 or len(movies) != 32 or not all("movieId" in m for m in movies):
            raise AssertionError(f"{url}: status {status}, {len(movies)} movies")
    return wall


def serving_phase(device: str = "cuda"):
    """Returns (launch counts during the HTTP run, requests/s, parity)."""
    import numpy as np
    import torch

    from sparrowrecsys_torch.config import DataConfig, ServingConfig
    from sparrowrecsys_torch.models import build_model
    from sparrowrecsys_torch.models.dien import NEGATIVE_COLS
    from sparrowrecsys_torch.ops.attention import din_attention
    from sparrowrecsys_torch.ops.fm import fm_cross
    from sparrowrecsys_torch.serving.assembler import FeatureAssembler
    from sparrowrecsys_torch.serving.feature_store import FeatureStore
    from sparrowrecsys_torch.serving.rankers import ModelScorer
    from sparrowrecsys_torch.serving.server import RecSysServer, load_catalog

    data = DataConfig(data_root=os.path.join(REPO, "data"))
    dm = load_catalog(data)
    asm = FeatureAssembler(FeatureStore.load(data.path("feature_store.json")), dm)
    models = KERNEL_MODELS + ZOO_MODELS

    def scorers(device):
        """The named full-feature scorers, and the id-only NeuralCF one."""
        named = {m: ModelScorer.from_checkpoint(
            build_model(m), data.path(f"modeldata/{m}"), asm, device=device,
            extra_int_cols=NEGATIVE_COLS if m == "dien" else ()) for m in models[:-1]}
        return named, ModelScorer.from_checkpoint(
            build_model("neuralcf"), data.path("modeldata/neuralcf"), device=device)

    named, ncf = scorers(device)
    server = RecSysServer(dm, ServingConfig(port=0, model_poll_s=0),
                          scorers=named, device=device, scorer=ncf)
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
        n_ranked = RANKED_REQUESTS * len(KERNEL_MODELS)
        wall = _ranked(base, users, KERNEL_MODELS, RANKED_REQUESTS)
        counts = {"fm_cross": fm_cross.launches, "din_attention": din_attention.launches}
        # A smoke reading of the host-bound serving rate over the whole
        # window, not a benchmark: one client process on the server's host.
        log(f"[serving] {n_ranked} ranked requests in {wall:.3f} s = "
            f"{n_ranked / wall:.1f} req/s over the whole window, concurrency "
            f"{CONCURRENCY}")
        log(f"[serving] kernel launches during the HTTP run: {json.dumps(counts)}")
        for name, n in counts.items():
            if n <= 0:
                raise AssertionError(f"{name} was not launched by the serving path")
        for m in ZOO_MODELS:
            zoo_wall = _ranked(base, users, (m,), ZOO_REQUESTS)
            log(f"[serving] {m}: {ZOO_REQUESTS} ranked requests in {zoo_wall:.3f} s = "
                f"{ZOO_REQUESTS / zoo_wall:.1f} req/s, concurrency {CONCURRENCY}")
        _, body = _get(base + "/metrics")
        waves = {m: json.loads(body)["batchers"][m] for m in models}
        log(f"[serving] waves {json.dumps(waves)}")

        # The device's wave scores against the same exports on the CPU.
        cands, _ = server.rec_for_you._candidate_set()
        cand_ids = [c.movie_id for c in cands]
        k = server.rec_for_you.model_batch
        wave_users = users[:k]
        cpu, cpu_ncf = scorers("cpu")
        cpu["neuralcf"] = cpu_ncf
        parity = {}
        for m in models:
            gpu_s = server.rec_for_you.scorers[m]
            gpu_s.prepare_wave(cand_ids, k)
            cpu[m].prepare_wave(cand_ids, k)
            got, ref = gpu_s.score_wave(wave_users), cpu[m].score_wave(wave_users)
            if got.shape != (k, len(cand_ids)) or not np.isfinite(got).all():
                raise AssertionError(f"{m}: wave scores {got.shape}, finite {np.isfinite(got).all()}")
            # 2.5e-5: the exports' float32 logit noise (1e-4 with raw
            # numerics, tests/test_torch_models.py and test_torch_zoo.py)
            # times the sigmoid's slope of 1/4; DeepFMv2 adds
            # twice its FM cross's rounding noise, from the CPU scorer's
            # fields (fm_logit_noise).
            tol = np.full(got.shape, 2.5e-5)
            if m == "deepfm_v2":
                model = cpu[m].model
                w_out = model.out.weight[0, 1:1 + model.proj_item.out_features].detach().numpy()
                noise = []
                for u in wave_users:
                    feats = cpu[m]._host_batch(cpu[m]._rows(u, cand_ids), len(cand_ids))
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
            breakdown = wave_breakdown(server, cand_ids, wave_users)
            log(f"[serving] wave breakdown: {json.dumps(breakdown)}")
        return counts, n_ranked / wall, parity
    finally:
        server.stop()


def wave_breakdown(server, cand_ids, wave_users, iters: int = 20):
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
        cols = [scorer._rows(u, mids) for u in wave_users]
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


# ---- phase 5 -----------------------------------------------------------------

def counters():
    """The kernels' wrappers (each carries its launch count), by name."""
    from sparrowrecsys_torch.ops import attention, fm, rowio

    return {"fm_cross": fm.fm_cross, "fm_cross_bwd": fm.fm_cross_bwd,
            "din_attention": attention.din_attention,
            "din_attention_bwd": attention.din_attention_bwd,
            "rows_gather": rowio.rows_gather, "rows_write": rowio.rows_write}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


#: Per model: the training data, the tables that take the lazy row-Adam,
#: the kernels its path must launch, and the fit's learning rate. Every
#: model at its shipped widths (D=10; DeepFMv2 fields of 64, deep 32/16;
#: DIN T=5, H=32; DIEN T=5, towers 128/64, attention and aux heads 32;
#: EmbeddingMLP and Wide&Deep hidden 128, a 10,000-bucket cross; NeuralCF
#: and its two-tower (10, 10)). DIN's only signal is sequential (the
#: candidate against the history) and 16 steps barely reach it: its last
#: AUC was 0.505 at the default 1e-3 and 0.509 at 1e-2 (this script on an
#: H100 80GB HBM3 at 700 W), so its fit takes 1e-2. DIEN's, on the same
#: data, takes the default 1e-3: at 1e-2 its fit amplifies float32
#: noise (the card's fit drifted 6.1e-3 and 1.01e-2 from the CPU's in two
#: runs of this script, the second beyond FIT_DRIFT_TOL). The NeuralCF
#: pair sees the ids alone, and the only signal there is the movie id's
#: parity, so theirs take 1e-2. An AUC that near 0.5 cannot tell a right
#: backward from a wrong one; the fit's check against the same fit on the
#: CPU (`fit_parity`) does.
TRAIN_MODELS = {
    "deepfm": ("synthetic_ctr_dataset", None, (), 1e-3),
    "deepfm_v2": ("synthetic_ctr_dataset",
                  {"emb_userId": ("userId",), "emb_movieId": ("movieId",)},
                  ("fm_cross", "fm_cross_bwd", "rows_gather", "rows_write"), 1e-3),
    "din": ("synthetic_sequence_ctr_dataset", None, ("din_attention", "din_attention_bwd"),
            1e-2),
    "embedding_mlp": ("synthetic_ctr_dataset", None, (), 1e-3),
    "wide_deep": ("synthetic_ctr_dataset", None, (), 1e-3),
    "neuralcf": ("synthetic_ctr_dataset", None, (), 1e-2),
    "neuralcf_two_tower": ("synthetic_ctr_dataset", None, (), 1e-2),
    "dien": ("synthetic_sequence_ctr_dataset", {"emb_userId": ("userId",)},
             ("rows_gather", "rows_write"), 1e-3),
}


def make_trainer(name, cfg, device=None):
    """The Trainer phase 5 gives `name`: its lazy row-Adam tables, and for
    DIEN `dien_loss_fn()` (the reference aux loss)."""
    from sparrowrecsys_torch.models import build_model
    from sparrowrecsys_torch.models.dien import dien_loss_fn
    from sparrowrecsys_torch.training.loop import Trainer

    return Trainer(build_model(name), cfg, sparse_tables=TRAIN_MODELS[name][1],
                   loss_fn=dien_loss_fn() if name == "dien" else None, device=device)


def train_data(name, rows):
    """The synthetic rows phase 5 trains `name` on; DIEN's with its negative
    history columns (seed 2020, as `training.run` adds them)."""
    from sparrowrecsys_torch.data import synthetic
    from sparrowrecsys_torch.data.negatives import add_dien_negatives

    ds = getattr(synthetic, TRAIN_MODELS[name][0])(rows, seed=20)
    return add_dien_negatives(ds, seed=2020) if name == "dien" else ds


def _fresh(trainer, params):
    """(params in the fit form, optimizer state) from a parameter dict."""
    p = {k: v.clone() for k, v in params.items()}
    opt = trainer.init_opt_state(p)
    if trainer.sparse_tables:
        p = trainer._dense_view(p)
    return p, opt


def _batch(ds, device, rows=None):
    import torch

    sl = slice(0, rows or TRAIN_BATCH)
    feats = {k: torch.from_numpy(v[sl]).to(device) for k, v in ds.features.items()}
    labels = torch.from_numpy(ds.labels[sl]).to(device)
    return feats, labels, torch.ones_like(labels)


#: The Dense layers a ReLU (DeepFM, DeepFMv2, EmbeddingMLP, Wide&Deep,
#: NeuralCF and its two-tower) or PReLU (DIN, DIEN) follows.
KINKED_LAYERS = ("deep1", "deep2", "fc1", "fc2", "dense1", "dense2", "interact0",
                 "interact1", "item0", "item1", "user0", "user1")


def kink_rows(trainer, params, feats, delta: float = 1e-5):
    """[B] bool: the batch rows whose forward on `trainer` (the CPU) puts a
    ReLU/PReLU input within `delta` times that tensor's largest magnitude
    of 0: the outputs of the Dense layers an activation follows
    (`KINKED_LAYERS`), and DIN's attention-unit pre-activations on live
    steps. There, two float32 evaluations may take different branches,
    and the row's gradient jumps by the whole branch difference: a true
    kink, not an error. (Two float32 sums of these widths differ by about
    1e-7 of their largest term; delta leaves 100x margin.)"""
    import torch

    import sparrowrecsys_torch.models.din as din_module

    outs, units = [], []
    hooks = [m.register_forward_hook(lambda _m, _i, o: outs.append(o))
             for n, m in trainer.model.named_modules() if n in KINKED_LAYERS]
    real = din_module.din_attention

    def recording(hist, cand, w1, b1, *rest):
        units.append((hist, cand, w1, b1))
        return real(hist, cand, w1, b1, *rest)

    din_module.din_attention = recording
    try:
        p, opt = params
        with torch.no_grad():
            trainer._forward(trainer._diff_leaves(p, opt), feats)
    finally:
        din_module.din_attention = real
        for hk in hooks:
            hk.remove()
    kink = torch.zeros(next(iter(feats.values())).shape[0], dtype=torch.bool)
    for z in outs:
        z = z.detach().abs()
        kink |= (z < delta * z.max()).reshape(kink.shape[0], -1).any(-1)
    with torch.no_grad():
        for hist, cand, w1, b1 in units:
            pre = unit_preactivations(hist, cand, w1, b1).abs()
            live = (hist != 0).any(-1)
            kink |= ((pre < delta * pre.max()).any(-1) & live).any(-1)
    return kink


def one_step_parity(name, ds, params, devices=("cuda", "cpu")):
    """Loss and every gradient of one batch on the card against the same
    weights and batch on the CPU (plain versions there). Rows at a
    ReLU/PReLU kink (`kink_rows`) are masked out of the loss on both."""
    import torch

    from sparrowrecsys_torch.config import TrainConfig

    cfg = TrainConfig(batch_size=TRAIN_BATCH)
    cpu = make_trainer(name, cfg, devices[-1])
    cpu_feats, _, _ = _batch(ds, devices[-1])
    cpu_params = {k: v.to(devices[-1]) for k, v in params.items()}
    keep = (~kink_rows(cpu, _fresh(cpu, cpu_params), cpu_feats)).float()
    out = []
    for dev in devices:
        trainer = make_trainer(name, cfg, dev)
        p, opt = _fresh(trainer, {k: v.to(dev) for k, v in params.items()})
        feats, labels, _ = _batch(ds, dev)
        _, loss, _, grads = trainer.loss_and_grads(p, opt, feats, labels, keep.to(dev))
        out.append((loss.item(), {k: v.float().cpu() for k, v in grads.items()}))
    (loss, grads), (ref_loss, ref_grads) = out
    # float32 with other summation orders (cuBLAS, the kernels, the
    # embedding backward's sums over 65536 rows): loss 1e-5 relative;
    # each gradient 1e-4 of its own scale (max |g| on the CPU).
    report = {"loss": loss, "cpu_loss": ref_loss, "loss_rel_err": abs(loss - ref_loss) / abs(ref_loss),
              "kink_rows_left_out": int((keep == 0).sum().item())}
    worst = {}
    for k, r in ref_grads.items():
        scale = r.abs().max().item()
        worst[k] = (grads[k] - r).abs().max().item() / max(scale, 1e-30)
    report["grad_err_over_scale_max"] = max(worst.values())
    report["grad_worst"] = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    log(f"[train] {name} one step, card vs cpu: {json.dumps(report)}")
    if not report["loss_rel_err"] <= 1e-5:
        raise AssertionError(f"{name}: loss {loss} vs cpu {ref_loss}")
    bad = {k: v for k, v in worst.items() if not v <= 1e-4}
    if bad:
        raise AssertionError(f"{name}: gradients beyond 1e-4 of scale: {bad}")
    return report


#: The card's fit against the CPU's, from the same weights and row order:
#: float32 noise (2e-6 of each gradient's scale a step) carried through
#: 16 Adam steps, where an element whose gradient sits at rounding noise
#: may step the other way (Adam's first steps are about -lr * sign(g)).
#: Per epoch: loss within 1e-3 relative, AUC within 1e-3; per parameter
#: tensor, the distance between the two fits' results within 1e-2 of the
#: distance the CPU fit moved it. A backward that drops or garbles a
#: gradient moves its parameters by a different distance altogether.
FIT_LOSS_RTOL, FIT_AUC_ATOL, FIT_DRIFT_TOL = 1e-3, 1e-3, 1e-2


def fit_parity(name, ds, params, cfg, result):
    """The same fit on the CPU (plain versions there), held against the
    card's `result`: per-epoch loss and AUC, and each parameter's drift
    from the CPU's result over the distance the CPU moved it. Counts the
    elements that differ by more than one Adam step (lr), as flips."""
    t0 = time.perf_counter()
    cpu = make_trainer(name, cfg, "cpu")
    ref = cpu.fit(ds, params={k: v.cpu() for k, v in params.items()}, verbose=False)
    report = {"cpu_fit_s": time.perf_counter() - t0, "loss_rel_err": [], "auc_err": []}
    for got, want in zip(result.history, ref.history):
        report["loss_rel_err"].append(abs(got["loss"] - want["loss"]) / abs(want["loss"]))
        report["auc_err"].append(abs(got["roc_auc"] - want["roc_auc"]))
    drift, flips = {}, 0
    for k, want in ref.params.items():
        got, init = result.params[k].float().cpu(), params[k].float().cpu()
        gap, moved = (got - want).norm().item(), (want - init).norm().item()
        drift[k] = gap / moved if moved > 0 else (0.0 if gap == 0 else math.inf)
        flips += int(((got - want).abs() > cfg.learning_rate).sum())
    report["drift_max"] = max(drift.values())
    report["drift_worst"] = sorted(drift.items(), key=lambda kv: -kv[1])[:3]
    report["elements_beyond_one_step"] = flips
    log(f"[train] {name} fit, card vs cpu: {json.dumps(report)}")
    bad = [f"epoch {e}: loss rel err {le}, auc err {ae}" for e, (le, ae)
           in enumerate(zip(report["loss_rel_err"], report["auc_err"]))
           if not (le <= FIT_LOSS_RTOL and ae <= FIT_AUC_ATOL)]
    bad += [f"{k}: drift {v}" for k, v in drift.items() if not v <= FIT_DRIFT_TOL]
    if len(result.history) != len(ref.history) or bad:
        raise AssertionError(f"{name}: the card's fit departs from the CPU's: {bad}")
    return report


def step_breakdown(trainer, params, ds, iters: int = 10):
    """One step's forward, backward and optimizer ms (CUDA events, back to
    back), and the device's busy time and idle share over `iters` whole
    steps under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from sparrowrecsys_torch.ops import metrics as M

    p, opt = _fresh(trainer, params)
    feats, labels, mask = _batch(ds, trainer.device)

    def forward():
        return trainer._loss(trainer._diff_leaves(p, opt), feats, labels, mask)

    _, _, _, grads = trainer.loss_and_grads(p, opt, feats, labels, mask)
    fwd = timed(forward, iters)
    fwd_bwd = timed(lambda: trainer.loss_and_grads(p, opt, feats, labels, mask), iters)
    optim = timed(lambda: trainer.apply_grads(p, opt, grads, feats), iters)
    mstate = M.init_metrics(trainer.device)
    import torch

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            p, opt, mstate = trainer._train_step(p, opt, mstate, feats, labels, mask)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    us = device_us(prof)
    ops = us.pop(None)
    busy_ms = sum(us.values()) / 1e3 / iters
    top = sorted(us.items(), key=lambda kv: -kv[1])[:6]
    return {"forward_ms": fwd, "backward_ms": fwd_bwd - fwd, "optimizer_ms": optim,
            "step_ms": fwd_bwd + optim, "profiled_step_ms": wall_ms,
            "device_busy_ms": busy_ms, "device_idle_share": 1 - busy_ms / wall_ms,
            "device_ops_per_step": ops / iters,
            "port_kernels_ms": {k: sum(v for n, v in us.items() if f"{k}_kernel" in n)
                                / 1e3 / iters for k in counters()},
            "top_device_ms": [[n[:80], v / 1e3 / iters] for n, v in top]}


def recurrence_breakdown(t: int = 5, d: int = 10, iters: int = 10):
    """DIEN's two recurrences alone (`ops/augru.py`, the autodiff loop DIEN
    trains with) at the train step's shape [TRAIN_BATCH, T, D]: device
    operations and busy ms per call of the forward and of forward plus
    backward, under torch.profiler. The launch count is what a CUDA graph
    of the step would fold."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sparrowrecsys_torch.ops.augru import AUGRUGate, AUGRUParams, GRUParams, augru, gru

    g = torch.Generator(device="cuda").manual_seed(3)

    def rand(*shape):
        return (torch.randn(*shape, generator=g, device="cuda") * 0.3).requires_grad_()

    x = torch.randn(TRAIN_BATCH, t, d, generator=g, device="cuda")
    mask = torch.rand(TRAIN_BATCH, t, generator=g, device="cuda") < 0.8
    att = torch.rand(TRAIN_BATCH, t, 1, generator=g, device="cuda").expand(-1, -1, d)
    gp = GRUParams(rand(d, 3 * d), rand(d, 3 * d), rand(3 * d))
    ap = AUGRUParams(*(AUGRUGate(rand(d, d), rand(d), rand(d, d)) for _ in range(3)))
    weights = list(gp) + [w for gate in ap for w in gate]

    def forward():
        return augru(ap, gru(gp, x, mask), att)

    def forward_backward():
        return torch.autograd.grad(forward().sum(), weights)

    out = {}
    for name, fn in (("forward", forward), ("forward_backward", forward_backward)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = device_us(prof)
        ops = us.pop(None)
        out[name] = {"device_ops": ops / iters, "device_busy_ms": sum(us.values()) / 1e3 / iters}
    return out


def training_phase():
    """Per model at the shipped widths and batch 65536: one step card vs
    CPU; a 2-epoch fit of 8 steps with the launch counters read around
    it; one step's breakdown. Returns {model: counts} of the fits."""
    import numpy as np

    from sparrowrecsys_torch.config import TrainConfig

    counts = {}
    for name, (_, _, path_kernels, lr) in TRAIN_MODELS.items():
        t0 = time.perf_counter()
        ds = train_data(name, TRAIN_BATCH * TRAIN_STEPS)
        log(f"[train] {name}: {len(ds)} synthetic rows in {time.perf_counter() - t0:.3f} s")
        cfg = TrainConfig(batch_size=TRAIN_BATCH, epochs=2, learning_rate=lr)
        trainer = make_trainer(name, cfg)
        params = trainer.init_params()
        one_step_parity(name, ds, params)

        reset_counts()
        result = trainer.fit(ds, params=params, verbose=True)
        counts[name] = read_counts()
        hist = result.history
        log(f"[train] {name} fit: {json.dumps(hist)}; {result.examples_per_sec:.1f} "
            f"examples/s over the steady epoch; launches {json.dumps(counts[name])}")
        if not hist[-1]["loss"] < hist[0]["loss"]:
            raise AssertionError(f"{name}: the loss did not fall: {hist}")
        if not hist[-1]["roc_auc"] > 0.5:
            raise AssertionError(f"{name}: last epoch's AUC {hist[-1]['roc_auc']} <= 0.5")
        if not all(np.isfinite(v.float().cpu().numpy()).all() for v in result.params.values()):
            raise AssertionError(f"{name}: non-finite parameters after the fit")
        for k in path_kernels:
            if counts[name][k] <= 0:
                raise AssertionError(f"{name}: {k} was not launched by the fit")
        fit_parity(name, ds, params, cfg, result)
        breakdown = step_breakdown(trainer, result.params, ds)
        log(f"[train] {name} step breakdown: {json.dumps(breakdown)}")
        if name == "dien":
            log(f"[train] dien recurrences alone, per call: {json.dumps(recurrence_breakdown())}")
    return counts


#: The models `hand_off` trains through `training.run` and serves.
HAND_OFF_MODELS = ("deepfm_v2", "dien")


def serving_inputs():
    """(assembler, user ids, 800 candidate ids) of the bundled catalog and
    feature store: what the server gives a scorer."""
    from sparrowrecsys_torch.config import DataConfig
    from sparrowrecsys_torch.serving.assembler import FeatureAssembler
    from sparrowrecsys_torch.serving.feature_store import FeatureStore
    from sparrowrecsys_torch.serving.server import load_catalog

    data = DataConfig(data_root=os.path.join(REPO, "data"))
    dm = load_catalog(data)
    asm = FeatureAssembler(FeatureStore.load(data.path("feature_store.json")), dm)
    with open(data.path("ratings.csv")) as f:
        next(f)
        users = list(dict.fromkeys(int(line.split(",")[0]) for line in f))
    return asm, users, [m.movie_id for m in dm.get_movies(800, "rating")]


def score_export(name, export_dir, device, inputs, k: int = 8):
    """The port's reader loads the newest export under `export_dir`, and
    the serving scorer (DIEN's with its zero negative columns, as the
    server gives it) ranks one [k x 800] wave with it."""
    import numpy as np

    from sparrowrecsys_torch.models import build_model
    from sparrowrecsys_torch.models.dien import NEGATIVE_COLS
    from sparrowrecsys_torch.serving.rankers import ModelScorer
    from sparrowrecsys_torch.training.checkpoint import load_latest, params_from_flax

    asm, users, cand_ids = inputs
    tree, version, meta = load_latest(export_dir)
    model = build_model(name)
    model.load_state_dict(params_from_flax(tree, model))
    scorer = ModelScorer.from_checkpoint(
        build_model(name), export_dir, asm, device=device,
        extra_int_cols=NEGATIVE_COLS if name == "dien" else ())
    scorer.prepare_wave(cand_ids, k)
    scores = scorer.score_wave(users[:k])
    if scores.shape != (k, len(cand_ids)) or not np.isfinite(scores).all():
        raise AssertionError(f"exported {name}: wave scores {scores.shape}")
    log(f"[handoff] export v{version} ({meta.get('model')}) scored a [{k} x {len(cand_ids)}] "
        f"wave on {device}: mean {scores.mean():.4f}, std {scores.std():.4f}")


def run_cli(module, args, device):
    """`python -m <module> <args>` from the repo root (`--cpu` on the
    CPU); its standard output. Fails when it does."""
    cmd = [sys.executable, "-m", module] + list(args) + (["--cpu"] if device == "cpu" else [])
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=REPO))
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[2:])} failed ({proc.returncode}):\n"
                             f"{proc.stderr[-3000:]}")
    log(f"[cli] {' '.join(cmd[2:5])} in {time.perf_counter() - t0:.3f} s: "
        + " | ".join(line for line in proc.stdout.splitlines()
                     if "epoch" in line or "test" in line or "resumed" in line))
    return proc.stdout


def scratch_dir():
    """A git-ignored directory of the checkout for temporary files."""
    path = os.path.join(REPO, "sparrowrecsys_torch", "_build")
    os.makedirs(path, exist_ok=True)
    return path


def hand_off(device: str = "cuda"):
    """`training.run` on the card exports each of HAND_OFF_MODELS, and the
    serving scorer ranks one wave with each export."""
    import tempfile

    inputs = serving_inputs()
    for name in HAND_OFF_MODELS:
        with tempfile.TemporaryDirectory(dir=scratch_dir()) as tmp:
            run_cli("sparrowrecsys_torch.training.run",
                    ["--model", name, "--epochs", "1", "--export", tmp], device)
            score_export(name, tmp, device, inputs)


# ---- phase 6 -----------------------------------------------------------------

#: The key count of the bundled feature job's feature_store.json (725
#: movies, 2,492 users), as tests/test_torch_feature_pipeline.py pins it.
STORE_KEYS = 3217
#: The four kernels a DeepFMv2 fit with both tables on the row-Adam runs.
RESUME_KERNELS = ("fm_cross", "fm_cross_bwd", "rows_gather", "rows_write")


def feature_job(out_dir):
    """The feature job on the bundled ratings and movies into `out_dir`:
    both CSVs byte-equal to the bundled ones, the hand-off loaded by the
    port's store. Then `build_samples` timed over 1,000,000 synthetic
    events (138,000 users, 27,000 movies) on a catalog of every movie id,
    as tools/device_pipeline_bench.py builds it."""
    from sparrowrecsys_torch.data import run as data_run
    from sparrowrecsys_torch.data.feature_pipeline import build_samples
    from sparrowrecsys_torch.data.synthetic import SyntheticSpec, synthetic_ratings
    from sparrowrecsys_torch.serving.feature_store import FeatureStore

    t0 = time.perf_counter()
    data_run.main(["--data-root", os.path.join(REPO, "data"), "--out-dir", out_dir,
                   "--export-features"])
    job_s = time.perf_counter() - t0
    equal = {}
    for name in ("trainingSamples.csv", "testSamples.csv"):
        with open(os.path.join(out_dir, name), "rb") as a, \
                open(os.path.join(REPO, "data", name), "rb") as b:
            equal[name] = a.read() == b.read()
    path = os.path.join(out_dir, "feature_store.json")
    with open(path) as f:
        hashes = json.load(f)["hashes"]
    store = FeatureStore.load(path)
    loaded = sum(store.hgetall(k) == v for k, v in hashes.items())

    spec = SyntheticSpec()
    t0 = time.perf_counter()
    ratings = synthetic_ratings(spec)
    gen_s = time.perf_counter() - t0
    catalog = synthetic_catalog(spec.n_movies)
    t0 = time.perf_counter()
    table = build_samples(ratings, catalog)
    build_s = time.perf_counter() - t0
    report = {"bundled_job_s": job_s, "csv_byte_equal": equal, "store_keys": len(hashes),
              "store_keys_loaded": loaded, "synthetic_events": len(ratings),
              "synthetic_ratings_s": gen_s, "build_samples_host_s": build_s,
              "build_samples_rows": len(table),
              "build_samples_events_per_s": len(ratings) / build_s}
    log(f"[offline] feature job: {json.dumps(report)}")
    if not all(equal.values()):
        raise AssertionError(f"the feature job's CSVs differ from the bundled ones: {equal}")
    if not loaded == len(hashes) == STORE_KEYS:
        raise AssertionError(f"feature store: {loaded} of {len(hashes)} keys loaded, "
                             f"want {STORE_KEYS}")
    if not 0 < len(table) <= len(ratings) or len(table.columns) != 27:
        raise AssertionError(f"build_samples gave {len(table)} rows, {len(table.columns)} columns")
    return report, {"ratings": ratings, "catalog": catalog, "table": table,
                    "build_s": build_s, "make_s": gen_s}


def synthetic_catalog(n_movies):
    """A catalog of every movie id 1..n_movies: years 1950-2019, two
    genres for odd ids and one for even."""
    import numpy as np

    from sparrowrecsys_torch.data.movielens import MovieCatalog

    ids = np.arange(1, n_movies + 1, dtype=np.int32)
    return MovieCatalog(movie_ids=ids, titles=[f"Movie {i}" for i in ids],
                        release_years=(1950 + ids % 70).astype(np.int32),
                        genres=[["Action", "Drama"] if i % 2 else ["Comedy"] for i in ids])


def state_tensors(params, opt_state):
    """Every parameter and optimizer-state tensor of a fit, by path."""
    import torch

    out = {f"params/{k}": v for k, v in params.items()}

    def walk(node, prefix):
        if isinstance(node, torch.Tensor):
            out[prefix] = node
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}")
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for k, v in zip(node._fields, node):
                walk(v, f"{prefix}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}/{i}")
    walk(opt_state, "opt")
    return out


def max_gap(a, b):
    """The largest |a - b| over every tensor of two fits' states, and where."""
    if set(a) != set(b):
        raise AssertionError(f"the fits' states differ in names: {sorted(set(a) ^ set(b))}")
    gaps = {k: (a[k].float() - b[k].float()).abs().max().item() if a[k].numel() else 0.0
            for k in a}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def resume_check(ds, state_dir):
    """DeepFMv2, both tables on the row-Adam, batch 65536, 2 x 8 steps on
    the card: two uninterrupted fits, then one epoch into `state_dir` and
    a fresh Trainer resuming it. Returns the resumed fit's launch counts."""
    import torch

    # PyTorch's deterministic kernels for these fits: with the default
    # ones a rare reordering of float sums moves the user table by
    # 1.14e-5 in one fit and not the other (a resumed fit 1.14e-5 from
    # two uninterrupted fits 5.96e-8 apart, H100, 700 W), so that the
    # pair's distance does not bound it; deterministic, the two fits and
    # the resumed one must agree bit for bit. An op without a
    # deterministic version raises here (`main` sets the cuBLAS
    # workspace this mode asks for before any CUDA work).
    torch.use_deterministic_algorithms(True)
    try:
        return _resume_check(ds, state_dir)
    finally:
        torch.use_deterministic_algorithms(False)


def _resume_check(ds, state_dir):
    import torch

    from sparrowrecsys_torch.config import TrainConfig

    cfg = TrainConfig(batch_size=TRAIN_BATCH, epochs=2, learning_rate=TRAIN_MODELS["deepfm_v2"][3])
    params = make_trainer("deepfm_v2", cfg).init_params()
    runs = []
    for _ in range(2):
        r = make_trainer("deepfm_v2", cfg).fit(ds, params=params, verbose=False)
        runs.append(state_tensors(r.params, r.opt_state))
    t0 = time.perf_counter()
    make_trainer("deepfm_v2", cfg).fit(ds, params=params, epochs=1, state_dir=state_dir,
                                       verbose=False)
    resumed_trainer = make_trainer("deepfm_v2", cfg)
    reset_counts()
    r = resumed_trainer.fit(ds, state_dir=state_dir, resume=True, verbose=True)
    counts = read_counts()
    resume_s = time.perf_counter() - t0
    pair, pair_at = max_gap(runs[0], runs[1])
    gap, gap_at = max_gap(state_tensors(r.params, r.opt_state), runs[0])
    report = {"deterministic": torch.are_deterministic_algorithms_enabled(),
              "tensors": len(runs[0]), "uninterrupted_pair_max_abs_diff": pair,
              "uninterrupted_pair_worst": pair_at, "resumed_max_abs_diff": gap,
              "resumed_worst": gap_at, "epochs_resumed": len(r.history),
              "save_resume_s": resume_s,
              "resumed_fit_launches": {k: counts[k] for k in RESUME_KERNELS}}
    log(f"[offline] resume, deepfm_v2 (sparse user and movie tables): {json.dumps(report)}")
    if len(r.history) != 1:
        raise AssertionError(f"the resumed fit ran {len(r.history)} epochs, want 1")
    if not (gap == 0 if pair == 0 else gap <= 2 * pair):
        raise AssertionError(f"the resumed fit departs from the uninterrupted one by {gap} "
                             f"({gap_at}); two uninterrupted fits by {pair}")
    for k in RESUME_KERNELS:
        if counts[k] <= 0:
            raise AssertionError(f"the resumed fit did not launch {k}")
    return counts


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def narrow_check(ds):
    """DeepFM with bfloat16 tables (float32 masters) and bfloat16 moments,
    batch 65536, 2 x 8 steps, on the card and on the CPU from the same
    weights: the loss falls and the last AUC beats 0.5; the masters and
    the float32 params drift from the CPU's within FIT_DRIFT_TOL; each
    bfloat16 table within one bfloat16 ulp of bf16(master), at the scale
    of max(|p|, |bf16(master)|, 4 lr) (the rebase rounds a step to
    bfloat16; an Adam step is at most about 3.2 lr). Then the dtype one
    DeepFMv2 step with bfloat16 tables hands `fm_cross`."""
    import torch

    import sparrowrecsys_torch.models.deepfm as deepfm_module
    from sparrowrecsys_torch.config import TrainConfig
    from sparrowrecsys_torch.models import build_model
    from sparrowrecsys_torch.training.loop import Trainer

    lr = 1e-3
    cfg = TrainConfig(batch_size=TRAIN_BATCH, epochs=2, learning_rate=lr,
                      bf16_table_params=True, big_moment_dtype="bfloat16")
    trainer = make_trainer("deepfm", cfg)
    params = trainer.init_params()
    narrow = [k for k, v in params.items() if v.dtype == torch.bfloat16]
    card = trainer.fit(ds, params=params, verbose=False)
    t0 = time.perf_counter()
    cpu = make_trainer("deepfm", cfg, "cpu").fit(
        ds, params={k: v.cpu() for k, v in params.items()}, verbose=False)
    cpu_s = time.perf_counter() - t0
    hist = card.history
    state = card.opt_state
    masters = [m for m in state.master_big if m is not None]
    cpu_masters = [m for m in cpu.opt_state.master_big if m is not None]
    init32 = {k: params[k].float().cpu() for k in narrow}
    drift = {}
    for k, m, cm in zip(narrow, masters, cpu_masters):
        moved = (cm - init32[k]).norm().item()
        drift[f"master/{k}"] = (m.cpu() - cm).norm().item() / moved
    for k, v in cpu.params.items():
        if k not in narrow:
            moved = (v - params[k].cpu()).norm().item()
            drift[k] = (card.params[k].cpu() - v).norm().item() / moved if moved else 0.0
    ulps = {}
    for k, m in zip(narrow, masters):
        t, target = card.params[k].float(), m.bfloat16().float()
        mag = torch.maximum(torch.maximum(t.abs(), target.abs()),
                            torch.full_like(t, 4 * lr))
        ulps[k] = ((t - target).abs() / 2.0 ** (torch.floor(torch.log2(mag)) - 7)).max().item()

    f32 = make_trainer("deepfm", TrainConfig(batch_size=TRAIN_BATCH))
    f32_params = f32.init_params()
    f32_state = f32.init_opt_state(f32_params)
    report = {
        "history": hist, "cpu_fit_s": cpu_s, "narrow_leaves": narrow,
        "drift_max": max(drift.values()),
        "drift_worst": sorted(drift.items(), key=lambda kv: -kv[1])[:3],
        "table_vs_bf16_master_ulps_max": max(ulps.values()),
        "bytes": {"tables_bf16": _nbytes(card.params[k] for k in narrow),
                  "tables_f32_run": _nbytes(f32_params[k] for k in narrow),
                  "moments_big_bf16": _nbytes(state.mu_big + state.nu_big),
                  "moments_big_f32_run": _nbytes(f32_state.mu_big + f32_state.nu_big),
                  "masters_f32": _nbytes(masters)},
    }
    # The dtype DeepFMv2's fields reach fm_cross with, bfloat16 tables on.
    seen = []
    real = deepfm_module.fm_cross

    def recording(fields):
        seen.append(str(fields.dtype))
        return real(fields)

    # Dense tables: bfloat16 tables with the row-Adam raise.
    v2 = Trainer(build_model("deepfm_v2"), TrainConfig(batch_size=TRAIN_BATCH,
                                                       bf16_table_params=True))
    p2 = v2.init_params()
    feats, labels, mask = _batch(train_data("deepfm_v2", TRAIN_BATCH), v2.device)
    deepfm_module.fm_cross = recording
    try:
        v2.loss_and_grads(p2, v2.init_opt_state(p2), feats, labels, mask)
    finally:
        deepfm_module.fm_cross = real
    report["deepfm_v2_bf16_tables"] = {
        "narrow_leaves": [k for k, v in p2.items() if v.dtype == torch.bfloat16],
        "fm_cross_input_dtype": seen}
    log(f"[offline] narrow deepfm, card vs cpu: {json.dumps(report)}")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError(f"narrow deepfm: the loss did not fall: {hist}")
    if not hist[-1]["roc_auc"] > 0.5:
        raise AssertionError(f"narrow deepfm: last epoch's AUC {hist[-1]['roc_auc']} <= 0.5")
    if not narrow or not report["drift_max"] <= FIT_DRIFT_TOL:
        raise AssertionError(f"narrow deepfm: drift from the CPU's fit {report['drift_worst']}")
    if not report["table_vs_bf16_master_ulps_max"] <= 1:
        raise AssertionError(f"narrow deepfm: a bfloat16 table is {ulps} ulps from its master")
    if seen != ["torch.float32"]:
        raise AssertionError(f"deepfm_v2 with bfloat16 tables handed fm_cross {seen}")
    return report


def offline_phase(device: str = "cuda"):
    """Phase 6. Returns the resumed fit's launch counts and the synthetic
    (ratings, catalog, host table, host build s) of the feature job."""
    import tempfile

    with tempfile.TemporaryDirectory(dir=scratch_dir()) as tmp:
        t0 = time.perf_counter()
        samples = os.path.join(tmp, "samples")
        _, synthetic = feature_job(samples)
        steps = {"feature_job": time.perf_counter() - t0}

        t0 = time.perf_counter()
        ds = train_data("deepfm_v2", TRAIN_BATCH * TRAIN_STEPS)
        counts = resume_check(ds, os.path.join(tmp, "state"))
        steps["resume"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        narrow_check(train_data("deepfm", TRAIN_BATCH * TRAIN_STEPS))
        steps["narrow"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        csvs = ["--train", os.path.join(samples, "trainingSamples.csv"),
                "--test", os.path.join(samples, "testSamples.csv")]
        state, export = os.path.join(tmp, "cli_state"), os.path.join(tmp, "cli_export")
        run_cli("sparrowrecsys_torch.training.run",
                ["--model", "deepfm_v2", *csvs, "--state-dir", state, "--epochs", "1"], device)
        out = run_cli("sparrowrecsys_torch.training.run",
                      ["--model", "deepfm_v2", *csvs, "--state-dir", state, "--resume",
                       "--epochs", "2", "--export", export], device)
        if "resumed train state at epoch 1" not in out or "epoch 1/2" in out \
                or "epoch 2/2" not in out:
            raise AssertionError(f"training.run --resume did not continue at epoch 2:\n{out}")
        metas = []
        for v in sorted(os.listdir(state)):
            with open(os.path.join(state, v, "meta.json")) as f:
                metas.append(json.load(f)["next_epoch"])
        if metas != [1, 2]:
            raise AssertionError(f"the CLI's train states hold next_epoch {metas}, want [1, 2]")
        score_export("deepfm_v2", export, device, serving_inputs())
        steps["cli"] = time.perf_counter() - t0
    log(f"[offline] steps in s: {json.dumps(steps)}")
    return counts, synthetic


# ---- phase 7 -----------------------------------------------------------------

#: JAX's `tools/emb_scale.py --events 1000000 --epochs 2 --batch-size 8192`
#: on a CPU (the reference's quality, not a speed): the planted cosine of
#: the SGNS neighbours and of random pairs, at SyntheticSpec()'s 138,000
#: users and 27,000 movies; no planted signal at that depth.
JAX_SCALE_QUALITY = {"neighbor_planted_cos": -0.0114, "random_pair_cos": -0.0101}
#: The same tool at 3,000 users, 800 movies and 300,000 events, 2 epochs:
#: a planted signal (margin 0.1657).
DENSE_SPEC = (3000, 800, 300_000)
JAX_DENSE_QUALITY = {"neighbor_planted_cos": 0.1692, "random_pair_cos": 0.0035}
#: The port's planted margin at DENSE_SPEC must be at least this (the
#: reference's is 0.1657), and at SyntheticSpec() its planted cosine
#: within SCALE_QUALITY_TOL of the reference's (4 standard errors of the
#: difference of two means over 2,560 neighbour pairs of 8-dim unit latents).
DENSE_MARGIN = 0.10
SCALE_QUALITY_TOL = 0.04
#: Prepared top-k: queries per wave, width, k and catalog sizes.
TOPK_Q, TOPK_D, TOPK_K = 256, 64, 10
TOPK_SIZES = (100_000, 1_000_000)
#: ALS's chunked sums at 1,000,000 synthetic events, chunk lowered to this.
ALS_PHASE_CHUNK = 250_000
#: ALS card against CPU, and chunked against direct sums: predictions
#: within ALS_PRED_TOL of their largest magnitude, factors within
#: ALS_FACTOR_TOL of theirs, RMSE within ALS_RMSE_TOL. Rank 10 at reg 0.01
#: leaves users and items with one or two ratings ill-conditioned: the
#: port and the JAX package, both float32 on a CPU, part by 9.9e-4 of
#: scale in the user factors of the bundled split and 4.9e-4 in its test
#: predictions, while their RMSEs agree to 1.3e-6
#: (tests/test_torch_als.py::test_bundled_split_within_the_card_gates).
ALS_PRED_TOL = 2e-3
ALS_RMSE_TOL = 1e-4
ALS_FACTOR_TOL = 1e-2


def cands(msg: str) -> None:
    log(f"[cands] {msg}")


def rel_gap(got, want) -> float:
    """max |got - want| over max |want|."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def cuda_seconds(fn, device: str = "cuda"):
    """(result, wall s) of fn() between two device synchronisations."""
    import torch

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def sgns_schedule(n_pairs, counts, cfg, device):
    """The initial table, epoch orders and per-step negatives, drawn on
    `device` in the order `train_sgns` draws them from its own generator."""
    import torch

    from sparrowrecsys_torch.embedding import item2vec as I

    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    packed = I.pack_alias(*I.build_alias_table(counts ** 0.75), device=device)
    init = (torch.rand((len(counts), cfg.dim), generator=gen, device=device)
            * (1.0 / cfg.dim) - 0.5 / cfg.dim)
    bs, steps = I.sgns_shape(n_pairs, cfg.batch_size)
    orders, negatives = [], []
    for _ in range(cfg.epochs):
        orders.append(I.epoch_order(n_pairs, cfg.batch_size, gen).cpu().numpy())
        negatives.append(torch.stack([I.alias_draw(packed, (bs, cfg.negatives), gen)
                                      for _ in range(steps)]).cpu().numpy())
    return init.cpu().numpy(), orders, negatives


def untied_ids_equal(got, want, scores, gap: float = 1e-5) -> bool:
    """Two rankings name the same id at every position, except where the
    reference's score there is within `gap` of a neighbour's (a near-tie
    that rounding may swap)."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b and not any(abs(scores[i] - scores[j]) <= gap
                              for j in (i - 1, i + 1) if 0 <= j < len(scores)):
            return False
    return len(got) == len(want)


def item2vec_checks(ratings, syn, device):
    """Bundled item2vec card against the CPU replay, synonyms, the scale
    run (pairs/s, two runs, quality) and the planted-signal run."""
    import dataclasses

    import numpy as np

    from sparrowrecsys_torch.data.synthetic import SyntheticSpec, synthetic_ratings
    from sparrowrecsys_torch.embedding import item2vec as I
    from sparrowrecsys_torch.tools.emb_quality import neighbor_quality, planted_item_latents

    cfg = I.Item2VecConfig()
    seqs = I.build_item_sequences(ratings)
    c, x, vocab, counts = I.skipgram_pairs(seqs, cfg.window)
    bs, steps = I.sgns_shape(len(c), cfg.batch_size)
    if (len(seqs), len(vocab), len(c), steps) != (2672, 625, 11406, 1):
        raise AssertionError(f"bundled pairs: {len(seqs)} sequences, V={len(vocab)}, "
                             f"{len(c)} pairs, {steps} steps")
    card, secs = cuda_seconds(
        lambda: I.train_sgns(c, x, len(vocab), counts, cfg, device=device), device)
    init, orders, negatives = sgns_schedule(len(c), counts, cfg, device)
    cpu = I.train_sgns(c, x, len(vocab), counts, cfg, device="cpu", init=init,
                       orders=orders, negatives=negatives)
    gap = rel_gap(card, cpu)
    cands(f"item2vec bundled: {len(seqs)} sequences, V={len(vocab)}, {len(c)} pairs, "
          f"{cfg.epochs} epochs x {steps} step(s) of {bs} in {secs:.3f} s on the card; "
          f"card vs the CPU replaying the card's draws: {gap:.3e} of scale")
    if not np.isfinite(card).all() or gap > 1e-4:
        raise AssertionError(f"item2vec bundled: card vs CPU replay {gap}")
    got = I.find_synonyms(vocab, card, 158, 20, device=device)
    want = I.find_synonyms(vocab, card, 158, 20, device="cpu")
    if len(got) != 20 or not untied_ids_equal([m for m, _ in got], [m for m, _ in want],
                                                [s for _, s in want]):
        raise AssertionError(f"findSynonyms(158): card {got} cpu {want}")
    cands(f"findSynonyms(158, 20) card = CPU where untied: {[m for m, _ in got[:8]]}...")

    # At scale: SyntheticSpec(), 2 epochs, the scatter branch's vocabulary.
    spec = SyntheticSpec()
    sseqs = I.build_item_sequences(syn)
    sc, sx, svocab, scounts = I.skipgram_pairs(sseqs, cfg.window)
    scfg = dataclasses.replace(cfg, epochs=2)
    _, ssteps = I.sgns_shape(len(sc), scfg.batch_size)
    runs = []
    for _ in range(2):
        runs.append(cuda_seconds(
            lambda: I.train_sgns(sc, sx, len(svocab), scounts, scfg, device=device), device))
    (emb, secs), (emb2, secs2) = runs
    rate = scfg.epochs * len(sc) / secs2
    same = bool(np.array_equal(emb, emb2))
    quality = neighbor_quality(svocab, emb, planted_item_latents(spec), device=device)
    cands(f"item2vec at scale: V={len(svocab)}, {len(sc)} pairs, {ssteps} steps/epoch x "
          f"{scfg.epochs}: {secs:.3f} s then {secs2:.3f} s = {rate:.0f} pairs/s; two runs "
          f"bit-equal: {same} (gap {rel_gap(emb2, emb):.3e} of scale); quality {quality} "
          f"(JAX on a CPU: {JAX_SCALE_QUALITY})")
    if (len(svocab), len(sc), ssteps) != (26989, 1386630, 169):
        raise AssertionError(f"synthetic pairs: V={len(svocab)}, {len(sc)} pairs, {ssteps}")
    if abs(quality["neighbor_planted_cos"]
           - JAX_SCALE_QUALITY["neighbor_planted_cos"]) > SCALE_QUALITY_TOL:
        raise AssertionError(f"item2vec at scale: quality {quality}")

    dspec = SyntheticSpec(*DENSE_SPEC)
    dseqs = I.build_item_sequences(synthetic_ratings(dspec))
    dc, dx, dvocab, dcounts = I.skipgram_pairs(dseqs, cfg.window)
    demb, dsecs = cuda_seconds(
        lambda: I.train_sgns(dc, dx, len(dvocab), dcounts, scfg, device=device), device)
    dq = neighbor_quality(dvocab, demb, planted_item_latents(dspec), device=device)
    margin = dq["neighbor_planted_cos"] - dq["random_pair_cos"]
    cands(f"item2vec planted signal at {DENSE_SPEC}: {len(dc)} pairs x 2 epochs in "
          f"{dsecs:.3f} s; quality {dq}, margin {margin:.4f} (JAX on a CPU: "
          f"{JAX_DENSE_QUALITY}; required >= {DENSE_MARGIN})")
    if margin < DENSE_MARGIN:
        raise AssertionError(f"item2vec planted margin {margin}")
    return {"bundled_s": secs, "pairs_per_s": rate, "bit_equal_runs": same,
            "quality": quality, "dense_quality": dq}, vocab, card


def walk_edges_ok(walks, vocab, src_dst_keys) -> bool:
    """Every step of every walk is an edge of the graph."""
    import numpy as np

    v = len(vocab)
    steps = [np.searchsorted(vocab, w) for w in walks if len(w) > 1]
    if not steps:
        return True
    a = np.concatenate([s[:-1] for s in steps]).astype(np.int64)
    b = np.concatenate([s[1:] for s in steps]).astype(np.int64)
    return bool(np.isin(a * v + b, src_dst_keys).all())


def deepwalk_checks(ratings, syn, device):
    """The dense walker on the bundled graph, the CSR walker on the
    synthetic one: edges, card = CPU on the same draws, walks/s, and the
    graph embedding's SGNS."""
    import dataclasses

    import numpy as np
    import torch

    from sparrowrecsys_torch.embedding import deepwalk as D
    from sparrowrecsys_torch.embedding.item2vec import (
        build_item_sequences,
        skipgram_pairs,
        train_sgns,
    )

    cfg = D.DeepWalkConfig()
    out = {}
    for label, seqs in (("dense, bundled", build_item_sequences(ratings)),
                        ("csr, synthetic", build_item_sequences(syn))):
        vocab, src, dst = D.adjacent_pairs(seqs)
        keys = np.unique(src.astype(np.int64) * len(vocab) + dst)
        gen = torch.Generator(device=device).manual_seed(cfg.seed)
        if label.startswith("dense"):
            _, trans, dist = D.transition_matrix(seqs)
            start, u = D.walk_draws(dist, cfg.sample_count, cfg.sample_length, gen)
            cdf, dead = D.dense_cdf(trans), dist == 0

            def walk(dev):
                return D.walk_dense(torch.from_numpy(cdf).to(dev),
                                    torch.from_numpy(dead).to(dev), start.to(dev), u.to(dev))
            whole = lambda: D.random_walks(seqs, cfg, device)[1]  # noqa: E731
        else:
            csr = D.transition_csr(seqs)
            start, u = D.walk_draws(csr.item_dist, cfg.sample_count, cfg.sample_length, gen)
            iters = D.bisect_iters(csr.rowptr)

            def walk(dev):
                t = [torch.from_numpy(a).to(dev) for a in (csr.rowptr, csr.dst, csr.cum)]
                return D.walk_csr(*t, start.to(dev), u.to(dev), iters)
            whole = lambda: D.random_walks_csr(csr, cfg, device)  # noqa: E731
        (card_w, card_v), dev_s = cuda_seconds(lambda: walk(device), device)
        cpu_w, cpu_v = walk("cpu")
        if not (torch.equal(card_w.cpu(), cpu_w) and torch.equal(card_v.cpu(), cpu_v)):
            raise AssertionError(f"deepwalk {label}: card and CPU walks differ on one draw")
        walks, secs = cuda_seconds(whole, device)
        dense = len(vocab) <= D.DENSE_WALK_MAX_VOCAB
        if dense != label.startswith("dense") or (not dense and len(keys) != 289697):
            raise AssertionError(f"deepwalk {label}: V={len(vocab)}, {len(keys)} edges")
        lengths = np.array([len(w) for w in walks])
        if len(walks) != cfg.sample_count or not walk_edges_ok(walks, vocab, keys):
            raise AssertionError(f"deepwalk {label}: a step off the graph")
        cands(f"deepwalk {label}: V={len(vocab)}, {len(keys)} distinct edges; "
              f"{cfg.sample_count} walks of <= {cfg.sample_length}: walker "
              f"{cfg.sample_count / dev_s:.0f} walks/s on the card, "
              f"{cfg.sample_count / secs:.0f} walks/s with the host's truncation; mean "
              f"length {lengths.mean():.3f}; every step on an edge; card = CPU on one draw")
        out[label] = {"walks_per_s": cfg.sample_count / secs,
                      "walker_walks_per_s": cfg.sample_count / dev_s}
        if label.startswith("dense"):
            # The shipped config (10 epochs of 8,192) ends non-finite on this
            # graph in both packages (the JAX package's train_deepwalk too;
            # data/modeldata/itemGraphEmb.csv is all NaN); 2 epochs stay finite.
            wc, wx, wv, wcounts = skipgram_pairs(walks, cfg.item2vec.window)
            for epochs in (2, cfg.item2vec.epochs):
                icfg = dataclasses.replace(cfg.item2vec, epochs=epochs)
                emb, ssecs = cuda_seconds(
                    lambda: train_sgns(wc, wx, len(wv), wcounts, icfg, device=device), device)
                rate = epochs * len(wc) / ssecs
                finite = bool(np.isfinite(emb).all())
                cands(f"deepwalk graph embedding: V={len(wv)}, {len(wc)} pairs x {epochs} "
                      f"epochs in {ssecs:.3f} s = {rate:.0f} pairs/s; finite: {finite}")
                if epochs == 2 and not finite:
                    raise AssertionError("deepwalk graph embedding at 2 epochs is not finite")
            out["graph_sgns_pairs_per_s"] = rate
    return out


def hand_off_emb(vocab, table, device):
    """`embedding.run` on the card writes the `emb` files into a temporary
    data root; the port's server started on that root answers the `emb`
    paths; an LSH index over the card's table answers as over the table
    read back from its file."""
    import shutil
    import tempfile

    import numpy as np

    from sparrowrecsys_torch.embedding.artifacts import load_embeddings_csv, write_embeddings_csv
    from sparrowrecsys_torch.embedding.lsh import LSHIndex
    from sparrowrecsys_torch.serving.server import server_from_args

    with tempfile.TemporaryDirectory(dir=scratch_dir()) as root:
        for name in ("movies.csv", "links.csv", "ratings.csv"):
            shutil.copy(os.path.join(REPO, "data", name), os.path.join(root, name))
        out_dir = os.path.join(root, "modeldata")
        t0 = time.perf_counter()
        run_cli("sparrowrecsys_torch.embedding.run",
                ["--graph-emb", "--user-emb", "--data-root", root, "--out-dir", out_dir], device)
        job_s = time.perf_counter() - t0
        sizes = {n: len(load_embeddings_csv(os.path.join(out_dir, n)))
                 for n in ("item2vecEmb.csv", "itemGraphEmb.csv", "userEmb.csv")}
        users = load_embeddings_csv(os.path.join(out_dir, "userEmb.csv"))
        server = server_from_args(["--data-root", root] + (["--cpu"] if device == "cpu" else []))
        server.port = 0
        server.start()
        try:
            base = f"http://localhost:{server.port}"
            user = next(iter(users))
            answers = {}
            for path in ("/getsimilarmovie?movieId=158&size=16&model=emb",
                         f"/getrecforyou?id={user}&size=32&model=emb"):
                status, body = _get(base + path)
                movies = json.loads(body) if body else []
                if status != 200 or not movies or not all("movieId" in m for m in movies):
                    raise AssertionError(f"{path}: status {status}, {body[:200]!r}")
                answers[path] = len(movies)
        finally:
            server.stop()

        path = os.path.join(root, "table.csv")
        write_embeddings_csv(path, vocab, table)
        back = load_embeddings_csv(path)
        read = np.stack([back[int(v)] for v in vocab])
        demo = int(np.flatnonzero(vocab == 158)[0])
        a, b = LSHIndex(table, vocab), LSHIndex(read, vocab)
        if not (np.array_equal(a.buckets, b.buckets)
                and a.query(table[demo], k=5) == b.query(read[demo], k=5)):
            raise AssertionError("LSH over the card's table differs from its file's")
    cands(f"hand-off: embedding.run on the card in {job_s:.3f} s wrote {sizes}; the server "
          f"on that data root answered {answers}; LSH query of 158 = {a.query(table[demo], 5)[:3]}"
          f"... equal over the table and its file")
    return {"job_s": job_s, "sizes": sizes}


def als_checks(ratings, syn, device):
    """ALS: the bundled split card against the CPU on the card's initial
    factors, seconds per iteration, recommendations, and the chunked sums
    at 1,000,000 events."""
    import numpy as np
    import torch

    import sparrowrecsys_torch.models.als as A

    cfg = A.ALSConfig()
    tr, te = A.split_80_20(ratings)
    n_u, n_i = len(np.unique(tr.user_ids)), len(np.unique(tr.movie_ids))
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    init = tuple((torch.rand((n, cfg.rank), generator=gen, device=device)
                  / np.sqrt(cfg.rank)).cpu().numpy() for n in (n_u, n_i))
    A.train_als(tr, A.ALSConfig(max_iter=1), device)  # the device libraries' first call
    card, secs = cuda_seconds(lambda: A.train_als(tr, cfg, device), device)
    cpu = A.train_als(tr, cfg, device="cpu", init=init)
    gaps = (rel_gap(card.user_factors, cpu.user_factors),
            rel_gap(card.item_factors, cpu.item_factors))
    pred_gap = rel_gap(card.transform_drop(te)[0], cpu.transform_drop(te)[0])
    cands(f"als bundled 80/20: {len(tr)} ratings, {n_u} users x {n_i} items, rank "
          f"{cfg.rank}, {cfg.max_iter} iterations in {secs:.3f} s = "
          f"{secs / cfg.max_iter * 1e3:.3f} ms/iteration; RMSE card {card.rmse(te):.6f}, "
          f"CPU {cpu.rmse(te):.6f}; card vs CPU from the card's initial factors: user "
          f"{gaps[0]:.3e}, item {gaps[1]:.3e} of scale, test predictions {pred_gap:.3e}")
    if (max(gaps) > ALS_FACTOR_TOL or pred_gap > ALS_PRED_TOL
            or abs(card.rmse(te) - cpu.rmse(te)) > ALS_RMSE_TOL):
        raise AssertionError(f"als card vs cpu: factors {gaps}, predictions {pred_gap}")
    recs_card = card.recommend_for_all_users(10, device)
    recs_cpu = card.recommend_for_all_users(10, device="cpu")
    scores = card.user_factors @ card.item_factors.T
    bad = [u for row, u in enumerate(card.user_ids)
           if not untied_ids_equal([m for m, _ in recs_card[int(u)]],
                                   [m for m, _ in recs_cpu[int(u)]],
                                   np.sort(scores[row])[::-1][:10])]
    cands(f"als recommend_for_all_users(10): {len(recs_card)} users, card = CPU where "
          f"untied ({len(bad)} users differ)")
    if bad:
        raise AssertionError(f"als recommendations differ for users {bad[:5]}")

    direct, dsecs = cuda_seconds(lambda: A.train_als(syn, cfg, device), device)
    keep = A.ALS_CHUNK_EVENTS
    A.ALS_CHUNK_EVENTS = ALS_PHASE_CHUNK
    try:
        chunked, csecs = cuda_seconds(lambda: A.train_als(syn, cfg, device), device)
    finally:
        A.ALS_CHUNK_EVENTS = keep
    cgaps = (rel_gap(chunked.user_factors, direct.user_factors),
             rel_gap(chunked.item_factors, direct.item_factors))
    cpred = rel_gap(chunked.predict(syn.user_ids, syn.movie_ids),
                    direct.predict(syn.user_ids, syn.movie_ids))
    cands(f"als at {len(syn)} synthetic events: direct {dsecs / cfg.max_iter * 1e3:.3f} "
          f"ms/iteration, chunks of {ALS_PHASE_CHUNK} {csecs / cfg.max_iter * 1e3:.3f} "
          f"ms/iteration; chunked vs direct: user {cgaps[0]:.3e}, item {cgaps[1]:.3e} of "
          f"scale, predictions {cpred:.3e}")
    if max(cgaps) > ALS_FACTOR_TOL or cpred > ALS_PRED_TOL:
        raise AssertionError(f"als chunked vs direct: factors {cgaps}, predictions {cpred}")
    return {"ms_per_iteration": secs / cfg.max_iter * 1e3,
            "ms_per_iteration_1m": dsecs / cfg.max_iter * 1e3, "gaps": gaps}


def retrieval_checks(ratings, device):
    """The retrieval trainer on the leave-one-out positives, card against
    the CPU on the card's orders; then the recall twin on the card."""
    import numpy as np
    import torch

    from sparrowrecsys_torch.models import build_model
    from sparrowrecsys_torch.tools import recall_eval as R
    from sparrowrecsys_torch.training.retrieval import RetrievalConfig, RetrievalTrainer

    train, test_pairs, _ = R.leave_one_out_split(ratings)
    pos = train.ratings >= R.POS_THRESHOLD
    users, movies = train.user_ids[pos], train.movie_ids[pos]
    cfg = RetrievalConfig(batch_size=1024, epochs=10, seed=0)
    n = len(users)
    steps = n // cfg.batch_size
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    orders = [torch.randperm(n, generator=gen, device=device)[: steps * cfg.batch_size]
              .cpu().numpy() for _ in range(cfg.epochs)]
    card_t = RetrievalTrainer(build_model("neuralcf_two_tower", hidden=(32, 32)), cfg, device)
    losses = []
    card, secs = cuda_seconds(lambda: card_t.fit_pairs(users, movies, losses=losses), device)
    cpu_t = RetrievalTrainer(build_model("neuralcf_two_tower", hidden=(32, 32)), cfg,
                             device="cpu")
    cpu = cpu_t.fit_pairs(users, movies, orders=orders)
    gap = max(rel_gap(card[k].cpu().numpy(), cpu[k].numpy()) for k in cpu)
    rate = cfg.epochs * steps * cfg.batch_size / secs
    cands(f"retrieval: {n} positive pairs, {steps} steps of {cfg.batch_size} x {cfg.epochs} "
          f"epochs in {secs:.3f} s = {rate:.0f} examples/s; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; card vs the CPU on the card's orders: {gap:.3e} of scale")
    if gap > 1e-3 or not losses[-1] < losses[0]:
        raise AssertionError(f"retrieval: gap {gap}, losses {losses}")

    with open(os.path.join(REPO, "recall.json")) as f:
        ref = json.load(f)
    import tempfile

    with tempfile.TemporaryDirectory(dir=scratch_dir()) as tmp:
        path = os.path.join(tmp, "recall.json")
        t0 = time.perf_counter()
        run_cli("sparrowrecsys_torch.tools.recall_eval", ["--json-out", path], device)
        recall_s = time.perf_counter() - t0
        with open(path) as f:
            got = json.load(f)
    m = got["n_test"]
    parts = []
    for key in ("popularity", "item2vec", "two_tower_retrieval", "two_tower_ctr", "tuned_blend"):
        p = got[key]
        parts.append(f"{key} {p:.4f} +- {math.sqrt(p * (1 - p) / m):.4f} "
                     f"(recall.json {ref[key]:.4f})")
    cands(f"recall@10 over {m} test users on the card in {recall_s:.3f} s: " + "; ".join(parts)
          + f"; blend beta {got['tuned_blend_beta']}")
    if got["popularity"] != ref["popularity"]:
        raise AssertionError(f"popularity recall {got['popularity']} != {ref['popularity']}")
    if not got["two_tower_retrieval"] > 3 * 10 / 1001:
        raise AssertionError(f"two-tower retrieval recall {got['two_tower_retrieval']}")
    return {"examples_per_s": rate, "gap": gap, "recall": got}


def topk_checks(device):
    """Prepared top-k at Q=256, D=64, k=10 over 100,000 and 1,000,000
    items in float32 and 1,000,000 in bfloat16: CUDA-event ms, float32
    prepared = unprepared, bfloat16's recall@10 against float32."""
    import torch

    from sparrowrecsys_torch.ops import topk as K

    gen = torch.Generator(device=device).manual_seed(0)
    out = {}
    for m in TOPK_SIZES:
        items = torch.randn((m, TOPK_D), generator=gen, device=device)
        queries = torch.randn((TOPK_Q, TOPK_D), generator=gen, device=device)
        prep = K.prepare_catalog(items)
        s, i = K.cosine_topk_prepared(queries, prep, TOPK_K)
        us, ui = K.cosine_topk(queries, items, TOPK_K)
        if not (torch.equal(i, ui) and torch.equal(s, us)):
            raise AssertionError(f"top-k at {m}: float32 prepared differs from unprepared")
        row = {
            "prepared_ms": timed(lambda: K.cosine_topk_prepared(queries, prep, TOPK_K), 10),
            "unprepared_ms": timed(lambda: K.cosine_topk(queries, items, TOPK_K), 10),
        }
        scores = K.cosine_scores(queries, items)
        row["top_k_ms"] = timed(lambda: K.top_k(scores, TOPK_K), 10)
        row["torch_topk_ms"] = timed(lambda: torch.topk(scores, TOPK_K), 10)
        del scores
        if m == TOPK_SIZES[-1]:
            prep16 = K.prepare_catalog(items, torch.bfloat16)
            s16, i16 = K.cosine_topk_prepared(queries, prep16, TOPK_K)
            if s16.dtype != torch.float32:
                raise AssertionError(f"bfloat16 catalog scored in {s16.dtype}")
            hits = sum(len(set(a) & set(b)) for a, b in zip(i16.tolist(), i.tolist()))
            row["bf16_ms"] = timed(lambda: K.cosine_topk_prepared(queries, prep16, TOPK_K), 10)
            row["bf16_recall_at_10"] = hits / (TOPK_Q * TOPK_K)
            del prep16
        cands(f"prepared top-k Q={TOPK_Q} D={TOPK_D} k={TOPK_K} M={m}: "
              + ", ".join(f"{k} {v:.4f}" for k, v in row.items())
              + "; float32 prepared = unprepared")
        out[m] = row
        del items, prep
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def candidates_phase(device: str = "cuda"):
    """Phase 7: the candidate-generation plane on the card (`device="cpu"`
    rehearses its control flow on the CPU)."""
    from sparrowrecsys_torch.data.movielens import load_ratings
    from sparrowrecsys_torch.data.synthetic import synthetic_ratings

    ratings = load_ratings(os.path.join(REPO, "data", "ratings.csv"))
    syn = synthetic_ratings()
    steps = {}
    t0 = time.perf_counter()
    report, vocab, table = item2vec_checks(ratings, syn, device)
    steps["item2vec"] = time.perf_counter() - t0
    for name, fn in (("deepwalk", lambda: deepwalk_checks(ratings, syn, device)),
                     ("hand_off", lambda: hand_off_emb(vocab, table, device)),
                     ("als", lambda: als_checks(ratings, syn, device)),
                     ("retrieval", lambda: retrieval_checks(ratings, device)),
                     ("topk", lambda: topk_checks(device))):
        t0 = time.perf_counter()
        report[name] = fn()
        steps[name] = time.perf_counter() - t0
    cands(f"steps in s: {json.dumps(steps)}")
    return report


# ---- phase 8 -----------------------------------------------------------------

#: MovieLens-20M's event count, at SyntheticSpec()'s 138,000 users and
#: 27,000 movies: the device pipeline's full size.
FULL_EVENTS = 20_000_000
#: Host seconds the full events may take to make: beyond that the count
#: is cut to the largest multiple of 1,000,000 that phase 6's rate fits.
EVENTS_BUDGET_S = 30.0
#: Events at the shipped widths: every id inside DeepFMv2's tables of
#: 30,001 users and 1,001 movies.
SHIPPED_SPEC = {"n_users": 30_000, "n_movies": 1_000, "n_events": 1_000_000}
#: Users whose 800 candidates go through the sidecar, and its poll.
SIDECAR_USERS = 64
SIDECAR_POLL_S = 0.5
#: The nearline stream's poll and window (RealTimeFeature.java's 100 ms
#: and 1 s): a rating reaches a request in about their sum.
STREAM_POLL_S = 0.1
STREAM_WINDOW_S = 1.0
STALENESS_LIMIT_S = 10.0
TRACE_WAVES = 5


def rest(msg: str) -> None:
    log(f"[rest] {msg}")


def tables_differ(got, want) -> list:
    """The columns of two SampleTables that differ in name, dtype or a value."""
    import numpy as np

    bad = sorted(set(got.columns) ^ set(want.columns))
    return bad + [k for k in want.columns if k in got.columns and (
        got[k].dtype != want[k].dtype or not np.array_equal(got[k], want[k]))]


def full_events(synthetic):
    """FULL_EVENTS, or the largest multiple of 1,000,000 that phase 6's
    rate of making events fits into EVENTS_BUDGET_S."""
    per_million = synthetic["make_s"] / (len(synthetic["ratings"]) / 1e6)
    return min(FULL_EVENTS, max(1, int(EVENTS_BUDGET_S / per_million)) * 1_000_000)


def pipeline_checks(device, synthetic):
    """`build_samples_device` against the host's `build_samples` on the
    bundled ratings and on phase 6's 1,000,000 synthetic events, with the
    device columns' CUDA-event ms, the host recompute's ms and the host
    pipeline's; then `device_feature_columns` alone at `full_events`, its
    chunked genre stage held bit for bit against the direct one
    (`genre_chunk = n`), and the peak memory of the chunked run."""
    import torch

    from sparrowrecsys_torch.data import device_pipeline as dp
    from sparrowrecsys_torch.data.feature_pipeline import build_samples
    from sparrowrecsys_torch.data.movielens import load_movies, load_ratings
    from sparrowrecsys_torch.data.synthetic import SyntheticSpec, synthetic_ratings

    ratings = load_ratings(os.path.join(REPO, "data", "ratings.csv"))
    catalog = load_movies(os.path.join(REPO, "data", "movies.csv"))
    t0 = time.perf_counter()
    table = build_samples(ratings, catalog)
    cases = {"bundled": (ratings, catalog, table, time.perf_counter() - t0),
             "synthetic_1M": (synthetic["ratings"], synthetic["catalog"], synthetic["table"],
                              synthetic["build_s"])}
    report = {}
    for name, (ratings, catalog, table, host_s) in cases.items():
        dp.device_feature_columns(ratings, catalog, device=device)  # first use
        cols, dev_ms = event_ms(
            lambda: dp.device_feature_columns(ratings, catalog, device=device), device)
        t0 = time.perf_counter()
        got = dp._host_samples(cols, 2)
        recompute_ms = (time.perf_counter() - t0) * 1e3
        bad = tables_differ(got, table)
        report[name] = {"events": len(ratings), "rows": len(got), "columns": len(got.columns),
                        "device_columns_ms": dev_ms, "host_recompute_ms": recompute_ms,
                        "host_build_samples_ms": host_s * 1e3, "columns_differing": bad}
        rest(f"device pipeline, {name}: {json.dumps(report[name])}")
        if bad or len(got.columns) != 27:
            raise AssertionError(f"{name}: build_samples_device differs from build_samples in {bad}")

    n = full_events(synthetic)
    spec = SyntheticSpec(n_events=n)
    t0 = time.perf_counter()
    ratings = synthetic_ratings(spec)
    make_s = time.perf_counter() - t0
    catalog = synthetic_catalog(spec.n_movies)
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    chunked, chunked_ms = event_ms(
        lambda: dp.device_feature_columns(ratings, catalog, device=device), device)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    direct, direct_ms = event_ms(lambda: dp.device_feature_columns(
        ratings, catalog, genre_chunk=n, device=device), device)
    bad = [k for k in direct if not torch.equal(chunked[k], direct[k])]
    report["full"] = {"events": n, "cut_from": FULL_EVENTS if n < FULL_EVENTS else None,
                      "events_make_s": make_s, "chunks": -(-n // dp.GENRE_CHUNK),
                      "device_columns_ms": chunked_ms, "direct_device_columns_ms": direct_ms,
                      "max_memory_allocated_bytes": peak, "columns_differing": bad}
    rest(f"device pipeline, full: {json.dumps(report['full'])}")
    if bad or n <= dp.GENRE_CHUNK:
        raise AssertionError(f"at {n} events the chunked genre stage differs from the direct "
                             f"one in {bad} (chunk {dp.GENRE_CHUNK})")
    return report


def device_fit(device):
    """Events at SHIPPED_SPEC (with the bundled catalog) become samples on
    the card (`encode_samples_device`, every feature on `device`) and train
    DeepFMv2 at batch TRAIN_BATCH, 2 epochs, both tables on the row-Adam;
    the loss falls and the four kernels launch. Then one more epoch of
    steps timed by `utils.StepTimer`, each step synchronised. Returns the
    fit's launch counts."""
    import torch

    from sparrowrecsys_torch.config import TrainConfig
    from sparrowrecsys_torch.data.device_pipeline import (
        device_feature_columns,
        encode_samples_device,
    )
    from sparrowrecsys_torch.data.movielens import load_movies
    from sparrowrecsys_torch.data.synthetic import SyntheticSpec, synthetic_ratings
    from sparrowrecsys_torch.ops import metrics as M
    from sparrowrecsys_torch.utils import StepTimer
    from sparrowrecsys_torch.utils.profiling import hard_sync

    ratings = synthetic_ratings(SyntheticSpec(**SHIPPED_SPEC))
    catalog = load_movies(os.path.join(REPO, "data", "movies.csv"))
    ds, encode_ms = event_ms(
        lambda: encode_samples_device(device_feature_columns(ratings, catalog, device=device)),
        device)
    off = [k for k, v in {**ds.features, "labels": ds.labels}.items()
           if not isinstance(v, torch.Tensor) or v.device.type != device]
    if off:
        raise AssertionError(f"encode_samples_device left {off} off {device}")
    cfg = TrainConfig(batch_size=TRAIN_BATCH, epochs=2,
                      learning_rate=TRAIN_MODELS["deepfm_v2"][3])
    trainer = make_trainer("deepfm_v2", cfg, device)
    # Columns that live on the trainer's device stay there whatever their
    # size: with no room for a host table's copy, the fit must train from
    # the card-built tensors as they are.
    trainer.device_resident_bytes = 0
    reset_counts()
    res = trainer.fit(ds, verbose=False)
    counts = read_counts()

    params, opt = _fresh(trainer, res.params)
    n = len(ds)
    steps = -(-n // TRAIN_BATCH)
    cols, labels = trainer._columns(ds)
    off = [k for k, v in {**cols, "labels": labels}.items() if v.device.type != device]
    if off:
        raise AssertionError(f"Trainer._columns moved {off} off {device}")
    order, valid = trainer._epoch_order(n, steps * TRAIN_BATCH, 2, None)
    mstate = M.init_metrics(trainer.device)
    timer = StepTimer(TRAIN_BATCH)
    timer.mark_sync(labels)
    for s in range(steps):
        sl = slice(s * TRAIN_BATCH, (s + 1) * TRAIN_BATCH)
        feats, lab = trainer._gather(cols, labels, order[sl])
        params, opt, mstate = trainer._train_step(params, opt, mstate, feats, lab, valid[sl])
        hard_sync(params)
        timer.tick()
    report = {"events": len(ratings), "rows": n, "encode_ms": encode_ms,
              "feature_device": device, "losses": [h["loss"] for h in res.history],
              "roc_auc": res.history[-1]["roc_auc"], "fit_examples_per_s": res.examples_per_sec,
              "steptimer_examples_per_s": timer.examples_per_sec,
              "launches": {k: counts[k] for k in RESUME_KERNELS}}
    rest(f"events -> DeepFMv2 on {device} tensors: {json.dumps(report)}")
    if not res.history[-1]["loss"] < res.history[0]["loss"]:
        raise AssertionError(f"the loss did not fall: {report['losses']}")
    for k in RESUME_KERNELS:
        if counts[k] <= 0:
            raise AssertionError(f"the fit on device-built samples did not launch {k}")
    return counts


def sidecar_checks(device):
    """`ScoringSidecar` over a DeepFMv2 scorer on `device` (the shipped
    export, copied): `RestScorer.score` of SIDECAR_USERS users x 800
    candidates gives the in-process scores bit for bit, requests/s at
    CONCURRENCY, and a new export served within 2 x SIDECAR_POLL_S."""
    import shutil
    import tempfile

    import numpy as np

    from sparrowrecsys_torch.models import build_model
    from sparrowrecsys_torch.serving.rankers import ModelScorer, RestScorer
    from sparrowrecsys_torch.serving.sidecar import ScoringSidecar
    from sparrowrecsys_torch.training import checkpoint

    asm, users, cands = serving_inputs()
    users = users[:SIDECAR_USERS]
    with tempfile.TemporaryDirectory(dir=scratch_dir()) as tmp:
        model_dir = os.path.join(tmp, "deepfm_v2")
        shutil.copytree(os.path.join(REPO, "data", "modeldata", "deepfm_v2"), model_dir)
        scorer = ModelScorer.from_checkpoint(build_model("deepfm_v2"), model_dir, asm,
                                             device=device)
        side = ScoringSidecar(scorer, port=0, poll_s=SIDECAR_POLL_S)
        side.start()
        try:
            client = RestScorer(f"http://localhost:{side.port}/v1/models/recmodel:predict")
            client.score(users[0], cands)
            differ = [u for u in users
                      if not np.array_equal(client.score(u, cands), scorer.score(u, cands))]
            t0 = time.perf_counter()
            with ThreadPoolExecutor(CONCURRENCY) as pool:
                got = list(pool.map(lambda u: client.score(u, cands), users * 4))
            wall = time.perf_counter() - t0
            before = client.score(users[0], cands)
            old = scorer.version
            tree = checkpoint.params_to_flax(
                {k: v * 1.5 for k, v in scorer.model.state_dict().items()}, scorer.model)
            t0 = time.perf_counter()
            checkpoint.save(tree, model_dir)
            while scorer.version == old and time.perf_counter() - t0 < 10 * SIDECAR_POLL_S:
                time.sleep(0.005)
            reload_s = time.perf_counter() - t0
            after = client.score(users[0], cands)
            report = {"users": len(users), "candidates": len(cands),
                      "users_not_bit_equal": differ, "requests": len(got),
                      "requests_per_s": len(got) / wall, "concurrency": CONCURRENCY,
                      "version": [old, scorer.version], "reload_s": reload_s,
                      "poll_s": SIDECAR_POLL_S,
                      "reloaded_scores_bit_equal": bool(np.array_equal(
                          after, scorer.score(users[0], cands))),
                      "scores_changed": not np.array_equal(after, before)}
        finally:
            side.stop()
    rest(f"sidecar, deepfm_v2 on {device}: {json.dumps(report)}")
    if differ or not all(np.isfinite(g).all() and len(g) == len(cands) for g in got):
        raise AssertionError(f"REST scores differ from the in-process ones for users {differ}")
    if scorer.version != old + 1 or reload_s > 2 * SIDECAR_POLL_S:
        raise AssertionError(f"the new export was served after {reload_s} s (version "
                             f"{scorer.version}), want {old + 1} within {2 * SIDECAR_POLL_S} s")
    if not report["reloaded_scores_bit_equal"] or not report["scores_changed"]:
        raise AssertionError("the sidecar does not score with the new export")
    return report


def _raw_get(port: int, path: str):
    """(status, content type, body) of a GET sent with the path as it is
    (urllib would resolve a '..')."""
    import http.client

    conn = http.client.HTTPConnection("localhost", port, timeout=60)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


def nearline_checks(device):
    """The port's server ranks with DIN on `device`, and a
    LatestRatingStream tails a temporary ratings file into its catalog: a
    positive rating appended for a user reaches the next /getrecforyou
    (`stream_into_ranker`). Then the webroot on the same server, and
    `utils.trace` around TRACE_WAVES waves. Returns the stream's report."""
    import tempfile

    from sparrowrecsys_torch.config import ServingConfig
    from sparrowrecsys_torch.models import build_model
    from sparrowrecsys_torch.serving.rankers import ModelScorer
    from sparrowrecsys_torch.serving.server import RecSysServer

    asm, users, cands = serving_inputs()
    scorer = ModelScorer.from_checkpoint(
        build_model("din"), os.path.join(REPO, "data", "modeldata", "din"), asm, device=device)
    server = RecSysServer(asm.dm, ServingConfig(port=0, model_poll_s=0),
                          scorers={"din": scorer}, device=device)
    server.start()
    try:
        with tempfile.TemporaryDirectory(dir=scratch_dir()) as tmp:
            report = stream_into_ranker(server, scorer, users, cands, tmp)
            webroot_checks(server)
            trace_checks(scorer, users, cands, server.rec_for_you.model_batch, tmp, device)
    finally:
        server.stop()
    return report


def stream_into_ranker(server, scorer, users, cands, tmp):
    """A LatestRatingStream on a new ratings file in `tmp`, attached to the
    server's catalog; a positive rating appended for a user, then ranked
    requests until one reflects it."""
    import numpy as np

    from sparrowrecsys_torch.nearline.stream import (
        FileWatchSource,
        LatestRatingStream,
        attach_to_store,
    )

    asm = scorer.assembler
    path = os.path.join(tmp, "ratings.csv")
    with open(path, "w") as f:
        f.write("userId,movieId,rating,timestamp\n")
    stream = LatestRatingStream(FileWatchSource(path, interval=STREAM_POLL_S),
                                window_seconds=STREAM_WINDOW_S, sink=lambda e: None)
    attach_to_store(stream, server.dm)
    stream.start()
    try:
        server.warmup()
        user = next(u for u in users if asm.user_row(u)["userRatedMovie1"] > 0)
        first = asm.user_row(user)["userRatedMovie1"]
        movie = next(m for m in cands if m != first)
        url = f"http://localhost:{server.port}/getrecforyou?id={user}&size=32&model=din"
        before = scorer.score(user, cands)
        before_body = _get(url)[1]
        time.sleep(2 * STREAM_POLL_S)  # the source's first poll skips the header
        with open(path, "a") as f:
            f.write(f"{user},{movie},5.0,{int(time.time())}\n")
        t_append = time.perf_counter()
        requests = 0
        while True:
            reflected = asm.user_row(user)["userRatedMovie1"] == movie
            status, body = _get(url)
            requests += 1
            staleness = time.perf_counter() - t_append
            if status != 200 or len(json.loads(body)) != 32:
                raise AssertionError(f"{url}: status {status}")
            if reflected or staleness > STALENESS_LIMIT_S:
                break
            time.sleep(0.02)
    finally:
        stream.stop()
    row = asm.user_row(user)
    after = scorer.score(user, cands)
    report = {"user": user, "movie": movie, "history_before": first,
              "history_after": [row[f"userRatedMovie{k}"] for k in range(1, 6)],
              "staleness_s": staleness, "requests_until_reflected": requests,
              "poll_s": STREAM_POLL_S, "window_s": STREAM_WINDOW_S,
              "din_scores_max_change": float(np.abs(after - before).max()),
              "ranking_changed": body != before_body}
    rest(f"nearline into the live DIN ranker on {scorer.device}: {json.dumps(report)}")
    if not reflected or row["userRatedMovie2"] != first:
        raise AssertionError(f"the streamed rating did not reach user {user}'s history "
                             f"within {STALENESS_LIMIT_S} s: {report}")
    if np.array_equal(after, before):
        raise AssertionError("the DIN scores did not change with the streamed rating")
    return report


def webroot_checks(server):
    """The pages byte for byte, a poster as SVG, paths outside the webroot 404."""
    web = {}
    for path, name in (("/", "index.html"), ("/index.html", "index.html"),
                       ("/js/recsys.js", "js/recsys.js")):
        status, _, body = _raw_get(server.port, path)
        with open(os.path.join(server.webroot, name), "rb") as f:
            web[path] = status == 200 and body == f.read()
    status, ctype, body = _raw_get(server.port, "/posters/1.jpg")
    web["/posters/1.jpg"] = (status, ctype) == (200, "image/svg+xml") and body.startswith(b"<svg")
    for path in ("/../", "/../server.py", "/webroot_x"):
        web[path] = _raw_get(server.port, path)[0] == 404
    rest(f"webroot: {json.dumps(web)}")
    if not all(web.values()):
        raise AssertionError(f"webroot checks failed: {web}")


def trace_checks(scorer, users, cands, k, tmp, device):
    """`utils.trace` around TRACE_WAVES [k x 800] waves writes one Chrome
    trace with the waves' events (the card's kernels among them)."""
    import glob

    from sparrowrecsys_torch.utils import trace

    scorer.prepare_wave(cands, k)
    log_dir = os.path.join(tmp, "trace")
    with trace(log_dir):
        for _ in range(TRACE_WAVES):
            scorer.score_wave(users[:k])
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    events = []
    for p in files:
        with open(p) as f:
            events += json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    prof = {"files": len(files), "bytes": sum(os.path.getsize(p) for p in files),
            "events": len(events), "device_kernel_events": kernels, "waves": TRACE_WAVES}
    rest(f"utils.trace around {TRACE_WAVES} DIN waves: {json.dumps(prof)}")
    if len(files) != 1 or not events or (device == "cuda" and not kernels):
        raise AssertionError(f"trace() wrote no Chrome trace of the waves: {prof}")


def rest_phase(device: str = "cuda", synthetic=None):
    """Phase 8: the feature pipeline on the card, events to a trained model
    without a host table, the sidecar, the nearline stream into the live
    ranker, the webroot and profiling. Returns the fit's launch counts."""
    steps = {}
    t0 = time.perf_counter()
    pipeline_checks(device, synthetic)
    steps["device_pipeline"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts = device_fit(device)
    steps["device_fit"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sidecar_checks(device)
    steps["sidecar"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nearline_checks(device)
    steps["nearline_webroot_trace"] = time.perf_counter() - t0
    rest(f"steps in s: {json.dumps(steps)}")
    return counts


# ---- phase 9 -----------------------------------------------------------------

#: Phase 9's fits: the shipped widths at buckets 30,002 / 1,002 (even, so
#: the 2x2 mesh can split them), batch 65536, 2 epochs of 4 steps, every
#: table of at least 16 rows row-sharded (the JAX dry run's `min_rows`),
#: the default learning rate. DeepFMv2's user table on the row-Adam.
MESH_MODELS = {"deepfm_v2": {"emb_userId": ("userId",)}, "din": None, "dien": None}
MESH_STEPS = 4
MESH_BUCKETS = (30002, 1002)
#: `tests/test_sharded_training.py`'s bounds against one device.
MESH_LOSS_TOL = {"deepfm_v2": 1e-3, "din": 2e-3, "dien": 2e-3}
MESH_AUC_TOL, MESH_PARAM_TOL = 5e-3, 1e-3
#: The sharded top-k: Q queries of D over M items, top k, on 2 model ranks.
MESH_TOPK = {"m": 1_000_000, "q": 256, "d": 64, "k": 10, "seed": 9, "time_iters": 20}
MESH_TOPK_TOL = 1e-5


def mesh(msg: str) -> None:
    log(f"[mesh] {msg}")


def card_label() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def mesh_case(name, device="cuda"):
    """A phase-9 fit case (`tools.dryrun_multichip`'s form) with its
    initial params, drawn once on the card and shared by every fit."""
    import torch

    from sparrowrecsys_torch.tools import dryrun_multichip as dm

    case = {"model": name, "buckets": MESH_BUCKETS, "rows": TRAIN_BATCH * MESH_STEPS,
            "seed": 20, "generator": TRAIN_MODELS[name][0], "min_rows": 16,
            "sparse_tables": MESH_MODELS[name],
            "config": {"batch_size": TRAIN_BATCH, "epochs": 2}}
    with torch.no_grad():
        init = dm.make_trainer(case, None, device).init_params()
    case["init"] = {k: v.cpu().numpy() for k, v in init.items()}
    return case


def fits_equal(a, b) -> float:
    """The largest parameter gap of two fit_case results (0.0: bit-equal
    params), and AssertionError if their histories differ."""
    from sparrowrecsys_torch.tools.dryrun_multichip import max_gap

    if a["history"] != b["history"]:
        raise AssertionError(f"histories differ: {a['history']} != {b['history']}")
    return max_gap(a["params"], b["params"])


def plan_step_ms(case, plans, device="cuda", steps: int = 10, rounds: int = 4):
    """ms per train step (batch TRAIN_BATCH, the case's first rows) of the
    case's model under each of `plans` ({label: plan or None}), the plans
    timed in turns: {label: (median, least, most)} over `rounds` runs of
    `steps` steps."""
    import numpy as np
    import torch

    from sparrowrecsys_torch.ops import metrics as M
    from sparrowrecsys_torch.tools import dryrun_multichip as dm

    ds = dm.case_data(case)
    fns = {}
    for label, plan in plans.items():
        trainer = dm.make_trainer(case, plan, device)
        state = list(trainer.prepare({k: torch.from_numpy(v) for k, v in case["init"].items()}))
        feats = {k: torch.from_numpy(np.ascontiguousarray(v[:TRAIN_BATCH])).to(trainer.device)
                 for k, v in ds.features.items()}
        labels = torch.from_numpy(ds.labels[:TRAIN_BATCH]).to(trainer.device)

        def run(trainer=trainer, state=state, feats=feats, labels=labels):
            mstate = M.init_metrics(trainer.device)
            for _ in range(steps):
                state[0], state[1], mstate = trainer._train_step(
                    state[0], state[1], mstate, feats, labels, torch.ones_like(labels))

        fns[label] = run
    return in_turns(fns, lambda fn: event_ms(fn, device)[1] / steps, rounds)


def one_rank_plans(cases, device="cuda"):
    """Phase 9 (a): DeepFMv2 and DIN with a 1x1 plan, in this process (no
    process group) and under a NCCL group of world size 1, each against
    two fits without a plan, under PyTorch's deterministic algorithms;
    then a train step's ms without a plan and with each 1x1 plan, in
    turns, and `measure_scaling([1])`. Returns the plan fits' launch
    counts and the single-card fits."""
    import torch
    import torch.distributed as dist

    from sparrowrecsys_torch.config import MeshConfig
    from sparrowrecsys_torch.parallel import build_mesh, init_distributed, measure_scaling
    from sparrowrecsys_torch.tools.dryrun_multichip import fit_case

    card = card_label()
    names = ("deepfm_v2", "din")
    fits = {name: {} for name in names}
    counts = {k: 0 for k in counters()}

    def planned(name, key, plan):
        nonlocal counts
        reset_counts()
        fits[name][key] = fit_case(cases[name], plan, device)
        counts = {k: v + read_counts()[k] for k, v in counts.items()}

    local_plan = build_mesh()
    torch.use_deterministic_algorithms(True)
    try:
        for name in names:
            fits[name]["runs"] = [fit_case(cases[name], None, device) for _ in range(2)]
            planned(name, "local", local_plan)
        with tempfile.TemporaryDirectory() as tmp:
            init_distributed("file://" + os.path.join(tmp, "rendezvous"), 1, 0,
                             backend="nccl" if device == "cuda" else "gloo")
            try:
                nccl_plan = build_mesh(MeshConfig(data_parallel=1, model_parallel=1))
                # A communicator starts at its group's first collective
                # (some 100 ms): start both before the timed fits.
                for axis in (nccl_plan.data_axis, nccl_plan.model_axis):
                    nccl_plan.all_gather(torch.zeros(1, device=device), axis)
                for name in names:
                    planned(name, "nccl", nccl_plan)
                torch.use_deterministic_algorithms(False)
                plans = {"no plan": None, "1x1 in process": local_plan,
                         "1x1 under NCCL": nccl_plan}
                step_ms = {name: plan_step_ms(cases[name], plans, device) for name in names}
                scaling = measure_scaling([1], per_device_batch=TRAIN_BATCH, steps=10,
                                          device=device)
            finally:
                dist.destroy_process_group()
    finally:
        torch.use_deterministic_algorithms(False)
    for name in names:
        runs, local, nccl = fits[name]["runs"], fits[name]["local"], fits[name]["nccl"]
        pair = fits_equal(runs[0], runs[1])
        gaps = {"in_process": fits_equal(local, runs[0]), "nccl_world_1": fits_equal(nccl, runs[0])}
        mesh(f"(a) {name} 1x1 plan against no plan: max param gap {json.dumps(gaps)} "
             f"(two fits without a plan: {pair}); collective bytes under NCCL "
             f"{json.dumps(nccl['collective_bytes'])}; examples/s over the steady epoch: "
             f"no plan {runs[0]['examples_per_sec']:.1f}, {runs[1]['examples_per_sec']:.1f}; "
             f"1x1 plan in process {local['examples_per_sec']:.1f}, under NCCL "
             f"{nccl['examples_per_sec']:.1f} ({card})")
        mesh(f"(a) {name} ms per train step at batch {TRAIN_BATCH}, median (least, most) of 4 "
             f"runs of 10 steps in turns: {json.dumps(step_ms[name])} ({card})")
        if any(g != 0 for g in gaps.values()) and not all(g <= 2 * pair for g in gaps.values()):
            raise AssertionError(f"{name}: a 1x1 plan departs from no plan by {gaps} "
                                 f"(two fits without one: {pair})")
    mesh(f"(a) measure_scaling([1]) under NCCL, DeepFM, batch {TRAIN_BATCH}: "
         f"{json.dumps([dataclass_dict(p) for p in scaling])} ({card})")
    return counts, {name: fits[name]["runs"][0] for name in names}


def dataclass_dict(obj) -> dict:
    import dataclasses

    return dataclasses.asdict(obj)


def deterministic_mesh_worker(plan, job, device):
    """`mesh_worker` under PyTorch's deterministic algorithms, as the
    single-card fits it is held to ran."""
    import torch

    from sparrowrecsys_torch.tools.dryrun_multichip import mesh_worker

    torch.use_deterministic_algorithms(True)
    return mesh_worker(plan, job, device)


def mesh_ranks(cases, singles, device="cuda"):
    """Phase 9 (b) and (c): four ranks on this one card over gloo (a 2x2
    mesh), DeepFMv2 (sparse user table), DIN and DIEN each held to the
    single-card fit within `tests/test_sharded_training.py`'s bounds; then
    `sharded_cosine_topk` over each data row's two model ranks against
    `cosine_topk` on the card. Both sides run under PyTorch's
    deterministic algorithms: with the default kernels a near-zero
    gradient's rounding can flip the sign of an Adam step (a DIN parameter
    1.8e-4 from the single card's in one run, 2.0e-7 in another, NVIDIA
    H100 80GB HBM3, 700.00 W), which would hide a fault of the sharding
    at the 1e-3 bound. A correctness run: four ranks share one card, so
    no speed is claimed. Returns the ranks' summed launches."""
    import numpy as np
    import torch

    from sparrowrecsys_torch.parallel import spawn_ranks
    from sparrowrecsys_torch.tools.dryrun_multichip import fit_case, max_gap

    singles = dict(singles)
    torch.use_deterministic_algorithms(True)
    try:
        singles["dien"] = fit_case(cases["dien"], None, device)
    finally:
        torch.use_deterministic_algorithms(False)
    job = [(name, "fit", cases[name]) for name in MESH_MODELS]
    job += [("topk_raw", "topk", MESH_TOPK), ("topk_prepared", "topk", {**MESH_TOPK, "prepared": True})]
    t0 = time.perf_counter()
    ranks = spawn_ranks(deterministic_mesh_worker, (2, 2), (job, device), backend="gloo",
                        timeout=600)
    mesh(f"(b) 4 ranks (2x2) over gloo, their tensors on {device} as they are: "
         f"{time.perf_counter() - t0:.1f} s with start-up")
    for name in MESH_MODELS:
        got, ref = ranks[0][name], singles[name]
        if any(r[name]["history"] != got["history"] for r in ranks[1:]):
            raise AssertionError(f"{name}: the ranks' histories differ")
        loss = max(abs(a["loss"] - b["loss"]) for a, b in zip(ref["history"], got["history"]))
        auc = max(abs(a["roc_auc"] - b["roc_auc"]) for a, b in zip(ref["history"], got["history"]))
        param = max_gap(ref["params"], got["params"])
        sharded = sorted(k for k, v in got["shardings"].items() if v)
        mesh(f"(b) {name} 2x2 against one card: max gaps loss {loss}, roc_auc {auc}, "
             f"param {param}; row-sharded {sharded}; collective bytes on rank 0 "
             f"{json.dumps(got['collective_bytes'])}")
        if not (loss < MESH_LOSS_TOL[name] and auc < MESH_AUC_TOL and param < MESH_PARAM_TOL):
            raise AssertionError(f"{name}: the 2x2 fit departs from one card "
                                 f"(loss {loss}, auc {auc}, param {param})")
    card = card_label()
    for kind in ("topk_raw", "topk_prepared"):
        for r in ranks:
            t = r[kind]
            np.testing.assert_array_equal(t["indices"], t["single_indices"])
            np.testing.assert_allclose(t["scores"], t["single_scores"], rtol=0, atol=MESH_TOPK_TOL)
        t = ranks[0][kind]
        mesh(f"(c) sharded_cosine_topk {kind}, Q={MESH_TOPK['q']} D={MESH_TOPK['d']} "
             f"k={MESH_TOPK['k']} over {MESH_TOPK['m']} items on 2 model ranks: indices equal "
             f"to one card's, max score gap {float(np.abs(t['scores'] - t['single_scores']).max())}"
             f"; {t['ms']:.3f} ms per call on rank 0 ({t['single_ms']:.3f} ms for the whole "
             f"catalog on one rank; four ranks share the card: not a speed) ({card})")
    return {k: sum(r["launches"][k] for r in ranks) for k in counters()}


def mesh_phase(device: str = "cuda"):
    """Phase 9: the multi-device plane on the one card. Returns the six
    kernels' launches under it; each must be at least 1."""
    cases = {name: mesh_case(name, device) for name in MESH_MODELS}
    local_counts, singles = one_rank_plans(cases, device)
    rank_counts = mesh_ranks(cases, singles, device)
    counts = {k: local_counts[k] + rank_counts[k] for k in counters()}
    mesh(f"launches: 1x1 plans {json.dumps(local_counts)}; 2x2 ranks "
         f"{json.dumps(rank_counts)}")
    for k, v in counts.items():
        if v <= 0:
            raise AssertionError(f"phase 9 did not launch {k}")
    return counts


def main() -> int:
    # The cuBLAS workspace that phase 6's deterministic fits ask for, set
    # before any CUDA work: on sm_90 it is PyTorch's default size (8
    # buffers of 4 MiB), so the other phases run as they would without it.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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

    t_start = time.perf_counter()
    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = card_label()
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
    fm_bwd_rows = [
        check_fm_cross_bwd((TRAIN_BATCH, 5, 64), torch.float32, 100),
        check_fm_cross_bwd((262144, 5, 128), torch.float32, 20),
        check_fm_cross_bwd((262144, 5, 128), torch.bfloat16, 20),
    ]
    din_bwd_rows = [
        check_din_attention_bwd(TRAIN_BATCH, 5, 10, 32, 20),
        check_din_attention_bwd(65536, 64, 128, 32, 3),
        # D=128, H=64: the shape whose block the first backward could not fit.
        check_din_attention_bwd(65536, 5, 128, 64, 10),
    ]
    row_rows = rows_cases(100, 20)
    host_path()
    torch.cuda.empty_cache()

    phase_s = {"kernels": time.perf_counter() - t_start}
    # 4. serving end to end
    t0 = time.perf_counter()
    serving_counts, _, _ = serving_phase()
    phase_s["serving"] = time.perf_counter() - t0

    # 5. training end to end, then the hand-off to serving
    t0 = time.perf_counter()
    train_counts = training_phase()
    phase_s["training"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    hand_off()
    phase_s["hand_off"] = time.perf_counter() - t0

    # 6. the offline plane
    t0 = time.perf_counter()
    offline_counts, synthetic = offline_phase()
    phase_s["offline"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # 7. the candidate-generation plane
    t0 = time.perf_counter()
    candidates_phase()
    phase_s["candidates"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # 8. the rest of the system
    t0 = time.perf_counter()
    rest_counts = rest_phase(synthetic=synthetic)
    phase_s["rest"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # 9. the multi-device plane on the one card
    t0 = time.perf_counter()
    mesh_counts = mesh_phase()
    phase_s["mesh"] = time.perf_counter() - t0
    log(f"[time] phases in s: {json.dumps(phase_s)}; "
        f"{time.perf_counter() - t_start:.1f} s in all")
    trained = {k: sum(c[k] for c in train_counts.values()) for k in counters()}
    counts = dict(trained, fm_cross=serving_counts["fm_cross"],
                  din_attention=serving_counts["din_attention"])
    counts = {k: v + offline_counts[k] + rest_counts[k] + mesh_counts[k]
              for k, v in counts.items()}

    # 10. summary
    def entry(name, route, source, replaces, rows):
        main_row = rows[0]
        return {
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": counts[name], "launches_training": trained[name],
            "launches_offline": offline_counts[name], "launches_rest": rest_counts[name],
            "launches_mesh": mesh_counts[name],
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
        entry("fm_cross_bwd", "cuda", "sparrowrecsys_torch/csrc/fm_cross.cu",
              "sparrowrecsys_tpu/ops/fm.py:62", fm_bwd_rows),
        entry("din_attention_bwd", "cuda", "sparrowrecsys_torch/csrc/din_attention.cu",
              "sparrowrecsys_tpu/ops/attention.py:119", din_bwd_rows),
        entry("rows_gather", "cuda", "sparrowrecsys_torch/csrc/rowio.cu",
              "sparrowrecsys_tpu/ops/rowio.py:103", row_rows["rows_gather"]),
        entry("rows_write", "cuda", "sparrowrecsys_torch/csrc/rowio.cu",
              "sparrowrecsys_tpu/ops/rowio.py:172", row_rows["rows_write"]),
    ]}
    log(json.dumps(summary))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

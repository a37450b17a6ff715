"""Microbenchmarks of the port's CUDA kernels: the six twins of
`tools/kernel_bench.py` (which times the Pallas kernels against XLA on
the TPU; DIN's pair in two designs, narrow and tensor-core), the
small-table embedding backward and DIEN's four scans.

    python -m sparrowrecsys_torch.tools.kernel_bench [--kernel NAME ...]
        [--host-path] [--json-out PATH]

Each kernel (fm_cross and din_attention with their backwards, rows_gather,
rows_write, embedding_bwd, the GRU's and AUGRU's scans forward and backward)
is checked against its plain PyTorch version on the card, at
the serving or training path's shapes and at the large shapes of
KERNELS.md, then timed: CUDA-event ms, device ms under torch.profiler,
the bound (the bytes it must move at HBM_BYTES_PER_S, or its operations
at the rate its arithmetic can reach, whichever is longer, counted on this
call's data: F32_FLOPS, and TC_F32_FLOPS for the wide DIN kernels, whose
products run on the tensor cores; the DIN rows give both), the plain
version's ms and, where one PyTorch call computes the same function
(`index_select`, `index_copy_`; for embedding_bwd the parent's backward,
the mask's `where` and `embedding_dense_backward`), its ms and device ms. Each timed call
reads inputs that are not in L2 (`cycling`, `row_sets`). The row kernels
run at the six row calls the DeepFMv2 trainer makes a step, kernel and
library call in turns; `host_path` (alone: `--host-path`) times the host
path of every wrapper the benchmark's cells launch, of the tensor-core
DIN pair and of the row wrappers, whole, and the row wrappers' part by part. The DIN backward's device time is the whole call's: its kernel
and reduce, and on the tensor cores' path the weight-gradient products
(cuBLAS), with the kernel's own time and the products alone. The DIN rows
run both designs: the narrow one (D <= 16, H <= 32) at the serving, T = 5
training and benchmark cell's shapes, the tensor cores' at D = 128.

One JSON row per kernel and shape, `{"kernel": name, ...}`, and the card's
name and power limit (nvidia-smi). Needs a CUDA card: without one it
exits non-zero. `chip_smoke.py` phase 3 runs `run()` and prints the rows.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

#: H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s and float32 FLOP/s
#: outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
#: The DIN kernels' float32-accurate products on the tensor cores: 495
#: TFLOP/s of TF32, three TF32 products (hi*hi, hi*lo, lo*hi) a float32
#: product. Their bound prices the operations at this rate.
TC_F32_FLOPS = 495e12 / 3
#: The H100's L2 (50 MB). A timed kernel cycles through copies of its
#: inputs that span four times this, so each call reads from HBM, as the
#: bound assumes, and not from the copy the call before left in L2.
L2_BYTES = 50 * 2 ** 20
#: The serving path's launch shapes: 8 requests x 800 candidates padded
#: to 8192 rows per wave; DeepFMv2 5 fields of 64, DIN T=5, D=10, H=32.
WAVE_ROWS = 8192
#: The training path's batch.
TRAIN_BATCH = 65536
#: The rows of DLRM-DCNv2's largest tables in the benchmark's cell.
DLRM_ROWS = 5_000_000
KERNELS = ("fm_cross", "din_attention", "fm_cross_bwd", "din_attention_bwd",
           "rows_gather", "rows_write", "embedding_bwd",
           "gru_scan_fwd", "gru_scan_bwd", "augru_scan_fwd", "augru_scan_bwd")


def card_label() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


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


def bound(nbytes: float, flops: float, rate: float = F32_FLOPS):
    """(ms, "bytes" or "operations"): the longer of moving `nbytes` at
    HBM_BYTES_PER_S and doing `flops` at `rate` (F32_FLOPS; TC_F32_FLOPS
    for the wide DIN kernels)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# The work each kernel's call must do, (bytes, operations): each input read
# once, each output written once; a multiply-add is two operations.


def fm_cross_cost(b, f, d, size):
    """x [B, F, D] read, [B, D] written; F adds a column for s and s^2,
    a square per element, and the difference."""
    return (b * f * d + b * d) * size, 3 * b * f * d + 2 * b * d


def fm_cross_bwd_cost(b, f, d, size):
    """x and g read, dx written; F adds per column for s, then a subtract
    and a multiply per element (2g once per column)."""
    return (2 * b * f * d + b * d) * size, 3 * b * f * d + b * d


def din_attention_cost(b, t, d, h, live_steps, live_rows):
    """The history, the candidate and the unit's weights read, [B, D]
    written. The candidate's share c @ (wc-wa) + b1 is one [D, H] product
    per row; each step adds h @ (wa+wb) + (h*c) @ wd, H for the second
    layer. An all-zero step gets weight 0 whatever the unit computes, so
    the work this data needs is the step part over the non-zero steps, and
    the row part over the rows with one."""
    nbytes = (b * t * d + b * d + 4 * d * h + 3 * h + 1 + b * d) * 4
    return nbytes, 2 * (live_steps * (2 * d * h + h) + live_rows * d * h)


def din_attention_bwd_cost(b, t, d, h, live_steps, live_rows):
    """The history, the candidate and the output gradient read, dh and dc
    written, the weights read and their gradients written. Operations per
    live step: the recompute (2*D*H + H), dh through the folded weight's
    wa+wb and wd blocks (2*D*H), and the weight gradients dk0 = h^T dapre,
    dk2 = (h*c)^T dapre (2*D*H), db1, dalpha, dw2 (3*H). Per row with a
    live step, on sum_t dapre_t (the candidate's terms see the step only
    through dapre): the candidate term of the recompute, dc's (wc-wa) dapre
    and dk1 = c^T dapre (D*H each). A masked step needs none of it:
    2 * (live_steps * (6*D*H + 4*H) + live_rows * 3*D*H)."""
    n_w = 4 * d * h + 3 * h + 1
    nbytes = (2 * (b * t * d + b * d) + b * d + 2 * n_w) * 4
    return nbytes, 2 * (live_steps * (6 * d * h + 4 * h) + live_rows * 3 * d * h)


def rows_gather_bytes(u, distinct, row_bytes):
    """Each distinct row read once (the trainer's drop slots are all
    clamped to row V-1) and the U int32 ids, U rows written."""
    return (distinct + u) * row_bytes + 4 * u


def rows_write_bytes(u, in_range, row_bytes):
    """The in-range rows read and written, every int32 id read."""
    return 2 * in_range * row_bytes + 4 * u


def embedding_bwd_bytes(n, d, v, id_bytes):
    """g's N rows and the N ids read once, the [V, D] gradient written."""
    return n * d * 4 + n * id_bytes + v * d * 4


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


def _launches(name: str) -> int:
    """A kernel's launches so far (`kernels.launch_counters()`)."""
    from sparrowrecsys_torch.ops.kernels import launch_counters

    return launch_counters()[name].launches


#: `host_path`'s calls a round for each wrapper: many for the row kernels,
#: which run in about the time their launch takes; few for the cells'
#: kernels (0.3-2 ms of device time each) and the wide DIN pair, so the
#: launch queue stays far from full and the host's time is read, not the
#: device's.
HOST_ITERS = {"rows_gather": 2000, "rows_write": 2000, "din_attention.narrow": 300,
              "din_attention_bwd.narrow": 100, "din_attention": 100, "din_attention_bwd": 100,
              "embedding_bwd": 200, "gru_scan_fwd": 100, "gru_scan_bwd": 100,
              "augru_scan_fwd": 100, "augru_scan_bwd": 100}
#: `host_path`'s rounds, taken in turns.
HOST_ROUNDS = 5


def host_path():
    """Host microseconds per call of the wrappers, host clock.

    `calls`: the whole call of every wrapper the benchmark's cells launch,
    at the cells' shapes (the narrow DIN forward and backward at [131072,
    64, 10], H = 32; `embedding_bwd` on DIN's movie lookup, [131072, 65]
    Zipf ids into the 1,001 x 10 table; the four scans at [131072, 64,
    10]), of the tensor-core DIN forward and backward kernels' wrappers at
    [8192, 64, 128], H = 32, and of the row wrappers at the trainer's
    (DeepFMv2's fused user buffer [30001, 30] f32, the touched ids of one
    synthetic batch as the row-Adam routes them): `HOST_ROUNDS` rounds in
    turns (`in_turns`), each `HOST_ITERS` calls, as (median, least, most)
    over the rounds.
    `rows`: the row wrappers part by part, the input checks
    (`rowio._check`) and a ctypes call of each entry point with the real
    pointers and the scalars of U = 0 (the C side returns before it reads
    the device or launches) and with the real scalars (the launch alone).
    `library_calls`: the PyTorch calls computing the row functions."""
    import ctypes

    import torch

    from sparrowrecsys_torch.data.synthetic import synthetic_ctr_dataset
    from sparrowrecsys_torch.ops import attention, augru, embedding, kernels, rowio
    from sparrowrecsys_torch.training.row_optim import _touched_rows

    gen = torch.Generator(device="cuda").manual_seed(13)
    users = torch.from_numpy(synthetic_ctr_dataset(TRAIN_BATCH, seed=11).features["userId"])
    uids, safe = _touched_rows(users.cuda(), 30001)
    table = torch.randn(30001, 30, device="cuda")
    rows = torch.randn(TRAIN_BATCH, 30, device="cuda")
    idx = table.get_device()

    def din_inputs(b, t, d, h):
        """hist, cand, the five weights and the output's gradient."""
        return (torch.randn(b, t, d, generator=gen, device="cuda"),
                torch.randn(b, d, generator=gen, device="cuda"),
                torch.randn(4 * d, h, generator=gen, device="cuda") / (4 * d) ** 0.5,
                torch.randn(h, generator=gen, device="cuda") * 0.1,
                torch.randn(h, generator=gen, device="cuda") * 0.1,
                torch.randn(h, 1, generator=gen, device="cuda") / h ** 0.5,
                torch.randn(1, generator=gen, device="cuda") * 0.1,
                torch.randn(b, d, generator=gen, device="cuda"))

    b, t, d = 131072, 64, 10
    din = din_inputs(b, t, d, 32)
    wide = din_inputs(8192, 64, 128, 32)
    movie_ids = zipf_ids(b * (t + 1), 1, 1001, 1.0, gen).view(b, t + 1)
    g_rows = torch.randn(b, t + 1, d, generator=gen, device="cuda")
    x = torch.randn(b, t, 3 * d, generator=gen, device="cuda") * 0.5
    mask = torch.ones(b, t, dtype=torch.bool, device="cuda")
    att = torch.rand(b, t, generator=gen, device="cuda")
    u = torch.randn(d, 3 * d, generator=gen, device="cuda") * 0.3
    u_rz, u_h = u[:, :2 * d].contiguous(), u[:, 2 * d:].contiguous()
    g_hs = torch.randn(b, t, d, generator=gen, device="cuda")
    hs = augru.gru_scan_fwd(u, x, mask)
    _, ahs = augru.augru_scan_fwd(u_rz, u_h, x, att)
    g_fin = g_hs[:, -1].contiguous()
    calls = {
        "rows_gather": lambda: rowio.rows_gather(table, safe),
        "rows_write": lambda: rowio.rows_write(table, uids, rows),
        "din_attention.narrow": lambda: attention._din_attention_kernel(*din[:7]),
        "din_attention_bwd.narrow": lambda: attention._din_narrow_bwd(*din),
        "din_attention": lambda: attention._din_attention_kernel(*wide[:7]),
        "din_attention_bwd": lambda: attention._din_attention_bwd_steps(*wide),
        "embedding_bwd": lambda: embedding.embedding_bwd(g_rows, movie_ids, 1001, 1),
        "gru_scan_fwd": lambda: augru.gru_scan_fwd(u, x, mask),
        "gru_scan_bwd": lambda: augru.gru_scan_bwd(u, x, mask, hs, g_hs),
        "augru_scan_fwd": lambda: augru.augru_scan_fwd(u_rz, u_h, x, att),
        "augru_scan_bwd": lambda: augru.augru_scan_bwd(u_rz, u_h, x, att, ahs, g_fin),
    }
    for name, fn in calls.items():
        before = _launches(name)
        fn()
        if _launches(name) != before + 1:
            raise AssertionError(f"host_path: {name}'s wrapper did not launch it once")
    whole = in_turns({k: (fn, HOST_ITERS[k]) for k, fn in calls.items()},
                     lambda item: host_us(*item), HOST_ROUNDS)

    valid = uids < table.shape[0]
    safe_long, valid_ids, valid_rows = safe.long(), uids[valid].long(), rows[valid]
    parts = {}
    for kind, args in (("rows_gather", (table, safe)), ("rows_write", (table, uids, rows))):
        entry, stream = kernels.TABLE[kind].function(), kernels.TABLE[kind].stream(idx)
        ptrs = (table.data_ptr(), args[1].data_ptr(), rows.data_ptr())
        plan = tuple(rowio.launch_plan(120, ptrs[0], ptrs[2], TRAIN_BATCH))
        empty_plan = tuple(rowio.launch_plan(120, ptrs[0], ptrs[2], 0))
        scalars = (ctypes.c_int64 * 7)(table.shape[0], TRAIN_BATCH, 120, *plan, idx)
        empty = (ctypes.c_int64 * 7)(table.shape[0], 0, 120, *empty_plan, idx)
        parts[kind] = {
            "check": host_us(lambda: rowio._check(kind, idx, *args)),
            "ctypes_empty_launch": host_us(lambda: entry(*ptrs, empty, stream)),
            "ctypes_launch": host_us(lambda: entry(*ptrs, scalars, stream)),
        }
    library_calls = {
        "index_select": host_us(lambda: torch.index_select(table, 0, safe_long)),
        "index_copy_": host_us(lambda: table.index_copy_(0, valid_ids, valid_rows)),
    }
    torch.cuda.synchronize()
    return {"rounds": HOST_ROUNDS, "iters": HOST_ITERS,
            "calls": {k: dict(zip(("median", "least", "most"), v)) for k, v in whole.items()},
            "rows": parts, "library_calls": library_calls}


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
    size = x.element_size()
    t_bound, by = bound(*fm_cross_cost(*shape, size))
    nxt = cycling((x,), x.numel() * size)
    row = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": err, "tol": tol,
           "ms": timed(lambda: fm_cross(*nxt()), iters),
           "plain_ms": timed(lambda: fm_cross_plain(*nxt()), iters),
           "bound_ms": t_bound, "bound_by": by, "library_ms": None,
           "device_ms": device_ms(lambda: fm_cross(*nxt()), iters, "fm_cross_kernel"),
           "plain_device_ms": device_ms(lambda: fm_cross_plain(*nxt()), iters)}
    return row


def din_bound(nbytes, flops, d, h) -> dict:
    """The DIN rows' bound: the narrow kernels (`ops/attention.py::narrow`)
    do their arithmetic in float32 FFMA, priced at F32_FLOPS; the wide
    ones on the tensor cores, at TC_F32_FLOPS. Both ways are given: bytes
    at HBM_BYTES_PER_S and operations at the kernel's rate."""
    from sparrowrecsys_torch.ops.attention import narrow

    rate = F32_FLOPS if narrow(d, h) else TC_F32_FLOPS
    t_bound, by = bound(nbytes, flops, rate)
    return {"bound_ms": t_bound, "bound_by": by, "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ops_ms": flops / rate * 1e3, "ops_rate": rate,
            "path": "narrow" if narrow(d, h) else "tensor_cores"}


def din_marker(d, h, backward=False) -> str:
    """The name that the DIN kernel of this shape's path carries."""
    from sparrowrecsys_torch.ops.attention import narrow

    if narrow(d, h):
        return "din_narrow_bwd" if backward else "din_narrow_fwd"
    return "din_attention_bwd" if backward else "din_attention_kernel"


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
    nxt = cycling((hist, cand), (b * t * d + b * d) * 4)
    weights = args[2:]
    row = {"shape": [b, t, d, h], "dtype": "float32", "max_abs_err": err,
           "ms": timed(lambda: din_attention(*nxt(), *weights), iters),
           "plain_ms": timed(lambda: din_attention_plain(*nxt(), *weights), iters),
           **din_bound(*din_attention_cost(b, t, d, h, *live_counts(hist)), d, h),
           "library_ms": None,
           "device_ms": device_ms(lambda: din_attention(*nxt(), *weights), iters,
                                  din_marker(d, h)),
           "plain_device_ms": device_ms(lambda: din_attention_plain(*nxt(), *weights), iters)}
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
    size = x.element_size()
    t_bound, by = bound(*fm_cross_bwd_cost(*shape, size))
    nxt = cycling((x, go), (x.numel() + go.numel()) * size)
    row = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": err, **extra,
           "ms": timed(lambda: fm_cross_bwd(*nxt()), iters),
           "plain_ms": timed(lambda: fm_cross_bwd_plain(*nxt()), iters),
           "bound_ms": t_bound, "bound_by": by, "library_ms": None,
           "device_ms": device_ms(lambda: fm_cross_bwd(*nxt()), iters, "fm_cross_bwd_kernel"),
           "plain_device_ms": device_ms(lambda: fm_cross_bwd_plain(*nxt()), iters)}
    return row


def unit_preactivations(hist, cand, w1, b1):
    """The DIN unit's pre-activations [B, T, H]: [h, c, h*c] @ the folded
    weight + b1, as the plain version computes them."""
    import torch

    from sparrowrecsys_torch.ops.attention import _fold

    ce = cand[:, None, :].expand_as(hist)
    return torch.cat([hist, ce, hist * ce], -1) @ _fold(w1, hist.shape[-1]) + b1


def check_din_attention_bwd(b, t, d, h, iters):
    import torch

    from sparrowrecsys_torch.ops.attention import (
        _din_attention_bwd_steps,
        _din_weight_grads,
        _tn,
        din_attention_bwd,
        din_attention_bwd_narrow_plain,
        din_attention_bwd_plain,
        narrow,
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
    refs = {"plain": din_attention_bwd_plain(hist, cand, *weights, go)}
    if narrow(d, h):
        refs["narrow_plain"] = din_attention_bwd_narrow_plain(hist, cand, *weights, go)
    again = din_attention_bwd(hist, cand, *weights, go)
    torch.cuda.synchronize()
    errs = {}
    for key, ref in refs.items():
        for name, x, r, y in zip(("dh", "dc", "dw1", "db1", "dalpha", "dw2", "db2"), got, ref,
                                 again):
            # float32 sums over B*T in another order than cuBLAS: 1e-4
            # relative and 1e-4 of the gradient's scale absolute.
            scale = max(r.abs().max().item(), 1.0)
            errs[name if key == "plain" else f"{name}_{key}"] = (x - r).abs().max().item()
            if not torch.allclose(x, r, rtol=1e-4, atol=1e-4 * scale):
                raise AssertionError(f"din_attention_bwd {(b, t, d, h)} {name} against {key}: "
                                     f"max err {(x - r).abs().max().item()}")
            if not torch.equal(x, y):
                raise AssertionError(f"din_attention_bwd {(b, t, d, h)} {name}: two runs differ")
    del got, refs, again
    live_steps, live_rows = live_counts(hist)
    nbytes, flops = din_attention_bwd_cost(b, t, d, h, live_steps, live_rows)
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
           **din_bound(nbytes, flops, d, h), "library_ms": None,
           # Every device operation of the call: the kernel and its reduce,
           # and on the tensor cores' path the weight-gradient products
           # (cuBLAS) with their allocations' and reductions' kernels.
           "device_ms": device_ms(lambda: call(din_attention_bwd), iters),
           "kernel_device_ms": device_ms(lambda: call(din_attention_bwd), iters,
                                         din_marker(d, h, True)),
           "plain_device_ms": device_ms(lambda: call(din_attention_bwd_plain), iters)}
    row["products_share"] = 1 - row["kernel_device_ms"] / row["device_ms"]
    if narrow(d, h):
        return row
    # The weight-gradient products alone on this call's per-step terms:
    # the wrapper's sliced products, one torch.mm each, and the products
    # in the other layout: on h and h*c apart (dapre read twice) where
    # the kernel wrote [h, h*c], on [h, h*c] (a copy of h) where it wrote
    # h*c alone.
    _, _, dapre, hx, dsum, _ = _din_attention_bwd_steps(hist, cand, *weights, go)
    flat = hist.view(-1, d)
    row["products_device_ms"] = device_ms(
        lambda: _din_weight_grads(hx, dapre, cand, dsum, hist), iters)
    if hx.shape[1] == d:
        row["mm_products_device_ms"] = device_ms(
            lambda: (torch.mm(flat.T, dapre), torch.mm(hx.T, dapre), torch.mm(cand.T, dsum)),
            iters)
        both = torch.cat([flat, hx], 1)
        row["other_layout_products_device_ms"] = device_ms(
            lambda: (_tn(both, dapre), _tn(cand, dsum)), iters)
    else:
        hc = hx[:, d:].contiguous()
        row["mm_products_device_ms"] = device_ms(
            lambda: (torch.mm(hx.T, dapre), torch.mm(cand.T, dsum)), iters)
        row["other_layout_products_device_ms"] = device_ms(
            lambda: (_tn(flat, dapre), _tn(hc, dapre), _tn(cand, dsum)), iters)
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
        before = _launches("rows_gather")
        out, ref = rows_gather(table, ids), rows_gather_plain(table, ids)
        launched = _launches("rows_gather") - before
        ok = torch.equal(out, ref)
        plan = launch_plan and launch_plan(row_bytes, table.data_ptr(), out.data_ptr(), u)
        del out, ref
        n_read = int(torch.unique(ids).numel())
        nbytes = rows_gather_bytes(u, n_read, row_bytes)
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
        before = _launches("rows_write")
        out = rows_write(table.clone(), ids, rows)
        launched = _launches("rows_write") - before
        ref = rows_write_plain(table.clone(), ids, rows)
        ok = torch.equal(out, ref)
        plan = launch_plan and launch_plan(row_bytes, table.data_ptr(), rows.data_ptr(), u)
        del out, ref
        n_read = int(valid.sum().item())
        nbytes = rows_write_bytes(u, n_read, row_bytes)
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
    return row


def rows_cases(iters_small, iters_large):
    """Both row kernels at the six calls the trainer makes per step
    (DeepFMv2's lazy row-Adam on its user and movie tables: the [V, 3D]
    buffer gather, the [V, D] gradient gather and the buffer write, with
    the ids of one synthetic batch of 65536 padded and routed as
    `_touched_rows` does), at DLRM-DCNv2's largest call of the benchmark's
    cell ([5,000,000, 384] and [5,000,000, 128] f32) and at the shapes of
    KERNELS.md ([2^21, 128] and
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
    # DLRM-DCNv2's largest row-Adam call in the benchmark's cell: feature
    # 20's 100 ids an example of 8192, Zipf(1.0) over a 5,000,000-row table
    # whose rows a seeded permutation scatters, routed as `_touched_rows`
    # does: the [V, 384] buffer gather and write, the [V, 128] gradient
    # gather.
    g = torch.Generator(device="cuda").manual_seed(7)
    v = DLRM_ROWS
    ids = torch.randperm(v, generator=g, device="cuda")[zipf_ids(8192 * 100, 0, v, 1.0, g).long()]
    uids, safe = _touched_rows(ids, v)
    buf = torch.randn(v, 384, generator=g, device="cuda")
    out["rows_gather"].append(check_rows("rows_gather", buf, [safe], iters_large,
                                         "dlrm feature 20 buffer"))
    out["rows_write"].append(check_rows("rows_write", buf, [uids], iters_large,
                                        "dlrm feature 20 buffer"))
    del buf
    torch.cuda.empty_cache()
    grad = torch.randn(v, 128, generator=g, device="cuda")
    out["rows_gather"].append(check_rows("rows_gather", grad, [safe], iters_large,
                                         "dlrm feature 20 gradient"))
    del grad, ids, uids, safe
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


def zipf_ids(n, lo, hi, s, generator):
    """n int32 ids in [lo, hi) on the card, id lo + r - 1 with probability
    proportional to 1 / r^s: the benchmark's movie ids."""
    import torch

    ranks = torch.arange(1, hi - lo + 1, device="cuda", dtype=torch.float64)
    cdf = torch.cumsum(ranks.pow(-s), 0)
    u = torch.rand(n, generator=generator, device="cuda", dtype=torch.float64) * cdf[-1]
    return (lo + torch.searchsorted(cdf, u).clamp_(max=hi - lo - 1)).to(torch.int32)


def check_embedding_bwd(b, t, v, d, lo, iters, label):
    """embedding_bwd on [B, T] ids into a [V, D] table: Zipf(1.0) over
    [1, V) where lo = 1 (DIN's movie lookup: the candidate and the
    history), else uniform over [-1, V + 1) (a genre column: -1 and ids
    >= V masked). Checked first on a gradient of multiples of 1/64 in
    [-1/16, 1/16], whose every partial sum is exact in float32: the kernel,
    its twin and the library call bit-equal, whatever their order; then on
    a normal gradient against a float64 sum (a float32 sum's error, within
    2^-20 of the cell's sum of |g|), two calls bit-equal. Timed beside the
    bound, the twin and the parent's backward (`where` on the mask, then
    `embedding_dense_backward` on the clamped int64 ids, both computed
    in the forward)."""
    import torch

    from sparrowrecsys_torch.ops.embedding import bwd_plan, embedding_bwd, embedding_bwd_plain

    gen = torch.Generator(device="cuda").manual_seed(3)
    n = b * t
    if lo:
        ids = zipf_ids(n, 1, v, 1.0, gen).view(b, t)
    else:
        ids = torch.randint(-1, v + 1, (b, t), generator=gen, device="cuda", dtype=torch.int32)
    valid = (ids >= lo) & (ids < v)
    safe = ids.clamp(0, v - 1).long()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = bwd_plan(n, v, d, 4, sms)

    def library(gg):
        masked = torch.where(valid.unsqueeze(-1), gg, gg.new_zeros(()))
        return torch.ops.aten.embedding_dense_backward(masked, safe, v, -1, False)

    exact = torch.randint(-4, 5, (b, t, d), generator=gen, device="cuda").float() / 64
    before = _launches("embedding_bwd")
    got = embedding_bwd(exact, ids, v, lo)
    launched = _launches("embedding_bwd") - before
    twin, lib = embedding_bwd_plain(exact, ids, v, lo, sms), library(exact)
    torch.cuda.synchronize()
    if launched != 1 or not torch.equal(got, twin) or not torch.equal(got, lib):
        raise AssertionError(f"embedding_bwd {label}: launched {launched}; exact sums differ "
                             f"from the twin by {(got - twin).abs().max().item()}, from the "
                             f"library by {(got - lib).abs().max().item()}")
    del exact, twin, lib
    g = torch.randn(b, t, d, generator=gen, device="cuda")
    got, again = embedding_bwd(g, ids, v, lo), embedding_bwd(g, ids, v, lo)
    keep = valid.reshape(-1)
    idx, rows = ids.reshape(-1)[keep].long(), g.reshape(-1, d)[keep]
    ref = torch.zeros(v, d, dtype=torch.float64, device="cuda").index_add_(0, idx, rows.double())
    l1 = torch.zeros(v, d, dtype=torch.float64, device="cuda").index_add_(
        0, idx, rows.double().abs())
    del idx, rows, keep
    err = (got.double() - ref).abs()
    twin_err = (embedding_bwd_plain(g, ids, v, lo, sms).double() - ref).abs()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"embedding_bwd {label}: two calls differ")
    if not bool((err <= l1 * 2 ** -20).all()):
        raise AssertionError(f"embedding_bwd {label}: max err {err.max().item()} against a "
                             f"float64 sum")
    counts = torch.bincount(ids[valid].long(), minlength=v)
    nbytes = embedding_bwd_bytes(n, d, v, 4)
    t_bound, by = bound(nbytes, n * d)
    nxt = cycling((g, ids), nbytes)
    calls = {"kernel": lambda: embedding_bwd(*nxt(), v, lo),
             "library": lambda: library(nxt()[0])}
    ms = in_turns(calls, lambda fn: timed(fn, iters), rounds=4)
    row = {"shape": [b, t, v, d], "lo": lo, "label": label, "dtype": "float32",
           "ids": "int32", "plan": plan._asdict(), "bytes": nbytes,
           "valid_rows": int(valid.sum().item()),
           "head_rows": int(counts.max().item()),
           "max_abs_err": err.max().item(), "twin_max_abs_err": twin_err.max().item(),
           "deterministic": True, "launches_per_call": launched,
           "ms": ms["kernel"][0], "ms_range": ms["kernel"][1:],
           "plain_ms": timed(lambda: embedding_bwd_plain(*nxt(), v, lo, sms), max(1, iters // 10)),
           "bound_ms": t_bound, "bound_by": by,
           "library_ms": ms["library"][0], "library_ms_range": ms["library"][1:],
           "device_ms": device_ms(calls["kernel"], iters, "embedding_bwd"),
           "plain_device_ms": device_ms(lambda: embedding_bwd_plain(*nxt(), v, lo, sms),
                                        max(1, iters // 10)),
           "library_device_ms": device_ms(calls["library"], iters)}
    return row


def gru_scan_cost(b, t, h, live_steps):
    """gru_scan_fwd: gx [B, T, 3H], the mask (a byte a step) and U [H, 3H]
    read, hs [B, T, H] written; 3H^2 multiply-adds a live step."""
    return (b * t * 3 * h + 3 * h * h + b * t * h) * 4 + b * t, 2 * live_steps * 3 * h * h


def gru_scan_bwd_cost(b, t, h, live_steps):
    """The GRU's backward: dhs [B, T, H], gx, the mask, U and hs read, dgx
    [B, T, 3H] and dU [H, 3H] written; the dh chain's 3H^2 and the weight
    gradients' 3H^2 multiply-adds a live step."""
    nbytes = (b * t * h + b * t * 3 * h + 3 * h * h + b * t * h
              + b * t * 3 * h + 3 * h * h) * 4 + b * t
    return nbytes, 2 * live_steps * 6 * h * h


def augru_scan_cost(b, t, h):
    """augru_scan_fwd: x [B, T, 3H], the attention [B, T], U_rz and U_h
    read, the final state [B, H] written; 3H^2 multiply-adds a step."""
    return (b * t * 3 * h + b * t + 3 * h * h + b * h) * 4, 2 * b * t * 3 * h * h


def augru_scan_bwd_cost(b, t, h):
    """The AUGRU's backward: dh [B, H], x, the attention, U and the final
    state read, dx [B, T, 3H], the attention's gradient [B, T] and dU
    written; 6H^2 multiply-adds a step."""
    nbytes = (b * h + b * t * 3 * h + b * t + 3 * h * h + b * h
              + b * t * 3 * h + b * t + 3 * h * h) * 4
    return nbytes, 2 * b * t * 6 * h * h


def check_scan(kernel, b, t, h, iters):
    """One of DIEN's scan kernels at [B, T, H] (every step live, as DIEN's
    histories of real ids are) against its twin, then timed beside its
    bound and the per-step loop it replaces: forward, the plain path's
    loop without gradients; backward, autograd's pass through that loop
    (the graph kept, `retain_graph`); and the twin, the plain version. The
    backward kernel's time is the kernel's alone; the bound is the whole
    backward's, whose weight-gradient products run after it. No PyTorch
    call computes the same function (`library_ms` None)."""
    import torch

    from sparrowrecsys_torch.ops import augru as A

    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(b, t, 3 * h, generator=gen, device="cuda") * 0.5
    mask = torch.ones(b, t, dtype=torch.bool, device="cuda")
    att = torch.rand(b, t, generator=gen, device="cuda")
    u = torch.randn(h, 3 * h, generator=gen, device="cuda") * 0.3
    u_rz, u_h = u[:, :2 * h].contiguous(), u[:, 2 * h:].contiguous()
    g = torch.randn(b, t, h, generator=gen, device="cuda")
    g_fin = g[:, -1].contiguous()
    gru = kernel.startswith("gru")
    if gru:
        hs = A.gru_scan_fwd(u, x, mask)
        twin_hs = A.gru_scan_fwd_plain(u, x, mask)
        fwd = lambda xx: A.gru_scan_fwd(u, xx, mask)  # noqa: E731
        bwd = lambda xx: A.gru_scan_bwd(u, xx, mask, hs, g)  # noqa: E731
        twin_bwd = lambda: A.gru_scan_bwd_plain(u, x, mask, twin_hs, g)  # noqa: E731
        nbytes, ops = (gru_scan_cost if kernel.endswith("fwd") else gru_scan_bwd_cost)(
            b, t, h, b * t)
    else:
        _, hs = A.augru_scan_fwd(u_rz, u_h, x, att)
        _, twin_hs = A.augru_scan_fwd_plain(u_rz, u_h, x, att)
        fwd = lambda xx: A.augru_scan_fwd(u_rz, u_h, xx, att)  # noqa: E731
        bwd = lambda xx: A.augru_scan_bwd(u_rz, u_h, xx, att, hs, g_fin)  # noqa: E731
        twin_bwd = lambda: A.augru_scan_bwd_plain(u_rz, u_h, x, att, twin_hs, g_fin)  # noqa: E731
        nbytes, ops = (augru_scan_cost if kernel.endswith("fwd") else augru_scan_bwd_cost)(
            b, t, h)
    call = fwd if kernel.endswith("fwd") else bwd
    got, again = call(x), call(x)
    want = (twin_hs if gru else A.augru_scan_fwd_plain(u_rz, u_h, x, att)) \
        if kernel.endswith("fwd") else twin_bwd()
    got, again, want = [v if isinstance(v, tuple) else (v,) for v in (got, again, want)]
    abs_errs = [float((a - w).abs().max()) for a, w in zip(got, want)]
    errs = [e / float(w.abs().max().clamp_min(1e-30)) for e, w in zip(abs_errs, want)]
    tol = 1e-5 if kernel.endswith("fwd") else 1e-4
    if max(errs) > tol or not all(torch.equal(a, c) for a, c in zip(got, again)):
        raise AssertionError(f"{kernel} [{b}, {t}, {h}]: errors against the twin {errs}")

    # The per-step loop the kernel replaces, on the same inputs.
    xs = x.detach().requires_grad_()
    x_tm = xs.transpose(0, 1)
    h0 = x.new_zeros(b, h)
    if gru:
        out = A._gru_scan(u, x_tm, mask.transpose(0, 1), h0).transpose(0, 1)
        loop_fwd = lambda: A._gru_scan(u, x_tm.detach(), mask.transpose(0, 1), h0)  # noqa: E731
        gout = g
    else:
        att_tm = att.transpose(0, 1)[..., None].expand(t, b, h)
        out = A._augru_scan(u_rz, u_h, x_tm, att_tm, h0)
        loop_fwd = lambda: A._augru_scan(u_rz, u_h, x_tm.detach(), att_tm, h0)  # noqa: E731
        gout = g_fin
    loop_bwd = lambda: torch.autograd.grad(out, xs, gout, retain_graph=True)  # noqa: E731
    loop = loop_fwd if kernel.endswith("fwd") else loop_bwd
    if kernel.endswith("fwd"):
        plain = (lambda: A.gru_scan_fwd_plain(u, x, mask)) if gru else \
            (lambda: A.augru_scan_fwd_plain(u_rz, u_h, x, att))
    else:
        plain = twin_bwd
    nxt = cycling((x,), x.numel() * 4)
    t_bound, by = bound(nbytes, ops)
    with torch.no_grad():
        ms = timed(lambda: call(nxt()[0]), iters)
        dev = device_ms(lambda: call(nxt()[0]), iters, kernel)
    loop_iters = max(1, iters // 10)
    return {"shape": [b, t, h], "dtype": "float32", "bytes": nbytes, "operations": ops,
            "max_abs_err": max(abs_errs), "max_rel_err": max(errs), "deterministic": True,
            "ms": ms, "device_ms": dev, "bound_ms": t_bound, "bound_by": by,
            "plain_ms": timed(plain, loop_iters), "plain_device_ms": device_ms(plain, loop_iters),
            "library_ms": None,
            "loop_ms": timed(loop, loop_iters), "loop_device_ms": device_ms(loop, loop_iters)}


def _cases() -> Dict[str, List[Callable[[], dict]]]:
    """Each kernel's checks, in order: the path's shape first."""
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    return {
        "fm_cross": [
            lambda: check_fm_cross((WAVE_ROWS, 5, 64), f32, 200),
            lambda: check_fm_cross((262144, 5, 128), f32, 50),
            lambda: check_fm_cross((262144, 5, 128), bf16, 50),
        ],
        "din_attention": [
            lambda: check_din_attention(WAVE_ROWS, 5, 10, 32, 200),
            # The trainer's forward at its batch.
            lambda: check_din_attention(TRAIN_BATCH, 5, 10, 32, 100),
            # The benchmark's training cell (narrow), then a wide shape
            # (the tensor cores).
            lambda: check_din_attention(131072, 64, 10, 32, 20),
            lambda: check_din_attention(65536, 64, 128, 32, 10),
        ],
        "fm_cross_bwd": [
            lambda: check_fm_cross_bwd((TRAIN_BATCH, 5, 64), f32, 100),
            lambda: check_fm_cross_bwd((262144, 5, 128), f32, 20),
            lambda: check_fm_cross_bwd((262144, 5, 128), bf16, 20),
        ],
        "din_attention_bwd": [
            lambda: check_din_attention_bwd(WAVE_ROWS, 5, 10, 32, 50),
            lambda: check_din_attention_bwd(TRAIN_BATCH, 5, 10, 32, 20),
            lambda: check_din_attention_bwd(131072, 64, 10, 32, 10),
            lambda: check_din_attention_bwd(65536, 64, 128, 32, 3),
            # D=128, H=64: the shape whose block the first backward could not fit.
            lambda: check_din_attention_bwd(65536, 5, 128, 64, 10),
        ],
        "embedding_bwd": [
            # DIN's movie lookup in the benchmark's cell: the candidate and
            # 64 history ids of 131072 rows into the 1,001 x 10 table.
            lambda: check_embedding_bwd(131072, 65, 1001, 10, 1, 50, "din movie"),
            # A genre column of that batch into its 19 x 10 table.
            lambda: check_embedding_bwd(131072, 1, 19, 10, 0, 200, "din genre"),
            # DLRM-DCNv2's largest small table at D = 128 (feature 24, 108
            # rows, one id an example of 8192).
            lambda: check_embedding_bwd(8192, 1, 108, 128, 0, 200, "dlrm feature 24"),
        ],
        # DIEN's recurrences in the benchmark's cell (batch 131072, 64-movie
        # histories) and at its published T = 5 at the training batch.
        **{k: [lambda k=k: check_scan(k, 131072, 64, 10, 20),
               lambda k=k: check_scan(k, TRAIN_BATCH, 5, 10, 100)]
           for k in ("gru_scan_fwd", "gru_scan_bwd", "augru_scan_fwd", "augru_scan_bwd")},
    }


def run(kernels=KERNELS, emit: Optional[Callable[[str, dict], None]] = None
        ) -> Dict[str, List[dict]]:
    """{kernel: [row per shape]} for `kernels`, each row checked against
    the plain version (a failed check raises) and timed; `emit(kernel,
    row)` is called as each row is done."""
    import torch

    emit = emit or (lambda name, row: None)
    out: Dict[str, List[dict]] = {}
    cases = _cases()
    for name in kernels:
        if name in cases:
            out[name] = []
            for case in cases[name]:
                out[name].append(case())
                emit(name, out[name][-1])
    rows = [k for k in ("rows_gather", "rows_write") if k in kernels]
    if rows:
        for kind, kind_rows in rows_cases(100, 20).items():
            if kind in rows:
                out[kind] = kind_rows
                for row in kind_rows:
                    emit(kind, row)
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", action="append", choices=KERNELS,
                    help="a kernel to time (repeatable); all of them by default")
    ap.add_argument("--host-path", action="store_true",
                    help="time the wrappers' host path alone (`host_path`), no kernel checks")
    ap.add_argument("--json-out", default="")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device; the kernels have no CPU mode", file=sys.stderr)
        return 2
    from sparrowrecsys_torch.ops import kernels as build

    torch.backends.cuda.matmul.allow_tf32 = False
    label = card_label()
    print(json.dumps({"card": label, "torch": torch.__version__}), flush=True)
    build.library()
    names = () if args.host_path else tuple(args.kernel or KERNELS)
    rows = []

    def emit(name, row):
        rows.append({"kernel": name, **row})
        print(json.dumps(rows[-1]), flush=True)

    run(names, emit)
    host = None
    if args.host_path or {"rows_gather", "rows_write"} & set(names):
        host = host_path()
        print(json.dumps({"kernel": "host_path", "us_per_call": host}), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"card": label, "rows": rows, "host_path_us": host}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

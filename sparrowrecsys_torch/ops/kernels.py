"""Build and load the port's hand-written CUDA kernels (`csrc/*.cu`).

The sources are compiled for Hopper (`sm_90a`) by `nvcc` at first use,
one `nvcc` process per source started together, and linked into one
shared library with a plain C interface, loaded with `ctypes`. The
library is cached under `sparrowrecsys_torch/_build/` by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one
is not.

Nothing here runs at import time: the CPU tests import every module on
a machine without `nvcc`.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

#: C entry points: name -> number of arguments. Each returns a cudaError_t
#: as int. Every argument is pointer-sized (a pointer, or an int64_t on the
#: C side) and declared `c_void_p`: ctypes converts a Python int to
#: `c_void_p` by a fast path, and to `c_int` or `c_int64` through a slower
#: generic one, which a launch would pay once per argument.
SIGNATURES = {
    # x, out, B, F, D, device, stream
    "fm_cross_f32": 7,
    "fm_cross_bf16": 7,
    # x, g, dx, B, F, D, device, stream
    "fm_cross_bwd_f32": 8,
    "fm_cross_bwd_bf16": 8,
    # hist, cand, w1, b1, alpha, w2, b2, out, int64 scalars (B, T, D, H,
    # the plan of ops/attention.py::plan, device), stream
    "din_attention_f32": 10,
    # the backward's scalars, grid (an int64_t written back)
    "din_attention_bwd_grid": 2,
    # hist, cand, w1, b1, alpha, w2, b2, g, dh, dc, dapre, hx, dsum,
    # scratch, small sums, scalars, grid, stream
    "din_attention_bwd_f32": 18,
    # hist, cand, w1, b1, alpha, w2, b2, out, int64 scalars (B, T, D, H,
    # rows a unit of ops/attention.py::unit_rows, device), stream
    "din_narrow_fwd_f32": 10,
    # hist, cand, w1, b1, alpha, w2, b2, g, dh, dc, scratch, grads,
    # scalars, stream
    "din_narrow_bwd_f32": 14,
    # table, ids, out, int64 scalars (V, U, row bytes, the plan of
    # ops/rowio.py::launch_plan, device), stream
    "rows_gather": 5,
    # table, ids, rows, int64 scalars, stream
    "rows_write": 5,
    # g, ids, partials, grad, int64 scalars (N, V, D, lo, id bytes, the
    # plan of ops/embedding.py::bwd_plan, device), stream
    "embedding_bwd_f32": 6,
    # gx, u, mask, hs, int64 scalars (B, T, H, device), stream
    "gru_scan_fwd_f32": 6,
    # gx, u, mask, hs, dhs, dgx, ops, dh0, scalars, stream
    "gru_scan_bwd_f32": 10,
    # x, u_rz, u_h, att, hs, hfin, scalars, stream
    "augru_scan_fwd_f32": 8,
    # x, u_rz, u_h, att, hs, dhfin, dx, ops, datt, dh0, scalars, stream
    "augru_scan_bwd_f32": 12,
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: What the last build printed (ptxas register and shared-memory use)
#: and how long it took in seconds; None when the library was cached.
build_log: str = ""
build_seconds: Optional[float] = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libsparrow_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile every `csrc/*.cu` in parallel and link one `.so`; returns
    its path. Raises `RuntimeError` with nvcc's output on failure."""
    global build_log, build_seconds
    so = library_path()
    if os.path.exists(so):
        build_seconds = None
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {os.path.basename(src)}\n{out}")
            if p.returncode != 0:
                failed.append(os.path.basename(src))
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp_so = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp_so,
             *[obj for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, so)
    build_seconds = time.perf_counter() - t0
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use. Once it is loaded,
    no lock is taken: a launch reads one global."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, n_args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_void_p] * n_args
                fn.restype = ctypes.c_int
            lib.sparrow_error_string.argtypes = [ctypes.c_int]
            lib.sparrow_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch_counters() -> dict:
    """The kernels' wrappers by name; each carries `launches`, the kernel
    calls since it was last set to 0. `din_attention` and
    `din_attention_bwd` count both DIN designs; `din_attention.narrow` and
    `din_attention_bwd.narrow` the narrow kernels alone."""
    from sparrowrecsys_torch.ops import attention, augru, embedding, fm, rowio

    return {"fm_cross": fm.fm_cross, "fm_cross_bwd": fm.fm_cross_bwd,
            "din_attention": attention.din_attention,
            "din_attention_bwd": attention.din_attention_bwd,
            "din_attention.narrow": attention.NarrowCount(attention.din_attention),
            "din_attention_bwd.narrow": attention.NarrowCount(attention.din_attention_bwd),
            "rows_gather": rowio.rows_gather, "rows_write": rowio.rows_write,
            "embedding_bwd": embedding.embedding_bwd,
            "gru_scan_fwd": augru.gru_scan_fwd, "gru_scan_bwd": augru.gru_scan_bwd,
            "augru_scan_fwd": augru.augru_scan_fwd, "augru_scan_bwd": augru.augru_scan_bwd}


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.sparrow_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def stream_of(device: int) -> int:
    """The raw handle of PyTorch's current CUDA stream on `device` (an
    index), for a C entry point. `torch.cuda.current_stream()` builds a
    Python `Stream` object on every call; this reads the handle alone
    (the call PyTorch's own generated kernels launch with)."""
    return torch._C._cuda_getCurrentRawStream(device)


def require_cuda(name: str, *tensors: torch.Tensor, dtypes=(torch.float32,)) -> int:
    """Raise unless every tensor is contiguous, of an accepted dtype and on
    the first tensor's CUDA device; returns that device's index."""
    dev = tensors[0].get_device()  # -1 off the card
    if dev < 0:
        raise ValueError(f"{name}: expected CUDA or CPU tensors, got {tensors[0].device}")
    for t in tensors:
        if t.get_device() != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {tensors[0].device}")
        if t.dtype not in dtypes:
            raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    return dev

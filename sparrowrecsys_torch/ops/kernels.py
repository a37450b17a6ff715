"""Build and load the port's hand-written CUDA kernels (`csrc/*.cu`).

The sources are compiled for Hopper (`sm_90a`) by `nvcc` at first use,
one `nvcc` process per source started together, and linked into one
shared library with a plain C interface, loaded with `ctypes`. The
library is cached under `sparrowrecsys_torch/_build/` by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one
is not.

Every C entry point is declared once, here, in `TABLE` (by name): a
`Kernel` (launched as `kernel(dev, *args)` on the current stream,
counted) or a `Query` (launches nothing). An op module binds its
declarations from `TABLE` at import and launches through them; `scalars`
gives a launch's int64 scalars as one cached array; `launch_counters`
gives every kernel by name. This module imports no op module.

Nothing here runs at import time: the CPU tests import every module on
a machine without `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools
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


class Entry:
    """One C entry point of the library, declared once in `TABLE`: `name`
    (its counter's name where it launches), `entry` (the C function) and
    `n_args` (its C parameters). Each returns a cudaError_t as int.

    On its first call after the library loads it resolves its ctypes
    function, once. Every argument is pointer-sized (a pointer, or an
    int64_t on the C side) and declared `c_void_p`: ctypes converts a
    Python int to `c_void_p` by a fast path, and to `c_int` or `c_int64`
    through a slower generic one, which a launch would pay once per
    argument."""

    __slots__ = ("name", "entry", "n_args", "_fn")

    def __init__(self, name: str, entry: str, n_args: int):
        self.name, self.entry, self.n_args = name, entry, n_args
        self._fn = None

    def function(self):
        """The ctypes function, its argument types set (the library is
        loaded, and built, on first use)."""
        if self._fn is None:
            fn = getattr(library(), self.entry)
            fn.argtypes = [ctypes.c_void_p] * self.n_args
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn


class Kernel(Entry):
    """An entry point that launches on a stream, its last parameter.
    `kernel(dev, *args)` launches it on PyTorch's current stream of device
    index `dev`, raises on a CUDA error and adds one to `launches` (the
    calls since it was last set to 0; `mfu_zoo` and `chip_smoke.py` set
    it)."""

    __slots__ = ("launches", "_stream")

    def __init__(self, name: str, entry: str, n_args: int):
        super().__init__(name, entry, n_args)
        self.launches = 0

    def function(self):
        fn = super().function()
        # The raw handle of the current stream: `torch.cuda.current_stream()`
        # builds a Python `Stream` object on every call; this reads the
        # handle alone (the call PyTorch's own generated kernels launch
        # with). A CPU build of torch has no such function.
        self._stream = torch._C._cuda_getCurrentRawStream
        return fn

    def stream(self, dev: int) -> int:
        """The raw handle of the stream a call on device index `dev`
        launches on, for a tool's raw call of `function()`."""
        self._fn or self.function()
        return self._stream(dev)

    def __call__(self, dev: int, *args) -> None:
        err = (self._fn or self.function())(*args, self._stream(dev))
        if err:
            check(err, self.name)
        self.launches += 1


class Query(Entry):
    """An entry point that launches nothing and takes no stream, called as
    `query(*args)`; not a launch, so not counted."""

    __slots__ = ()

    def __call__(self, *args) -> None:
        err = (self._fn or self.function())(*args)
        if err:
            check(err, self.name)


#: Every C entry point of `csrc/*.cu` but the library's own
#: `sparrow_error_string`, by name. The `int64 scalars` argument is one
#: `scalars(...)` array.
TABLE = {e.name: e for e in (
    # x, out, int64 scalars (B, F, D, device), stream
    Kernel("fm_cross", "fm_cross_f32", 4),
    Kernel("fm_cross.bf16", "fm_cross_bf16", 4),
    # x, g, dx, scalars, stream
    Kernel("fm_cross_bwd", "fm_cross_bwd_f32", 5),
    Kernel("fm_cross_bwd.bf16", "fm_cross_bwd_bf16", 5),
    # hist, cand, w1, b1, alpha, w2, b2, out, int64 scalars (B, T, D, H,
    # the plan of ops/attention.py::plan, device), stream
    Kernel("din_attention", "din_attention_f32", 10),
    # the backward's scalars, grid (an int64_t written back)
    Query("din_attention_bwd.grid", "din_attention_bwd_grid", 2),
    # hist, cand, w1, b1, alpha, w2, b2, g, dh, dc, dapre, hx, dsum,
    # scratch, small sums, scalars, grid, stream
    Kernel("din_attention_bwd", "din_attention_bwd_f32", 18),
    # hist, cand, w1, b1, alpha, w2, b2, out, int64 scalars (B, T, D, H,
    # rows a unit of ops/attention.py::unit_rows, device), stream
    Kernel("din_attention.narrow", "din_narrow_fwd_f32", 10),
    # hist, cand, w1, b1, alpha, w2, b2, g, dh, dc, scratch, grads,
    # scalars, stream
    Kernel("din_attention_bwd.narrow", "din_narrow_bwd_f32", 14),
    # table, ids, out, int64 scalars (V, U, row bytes, the plan of
    # ops/rowio.py::launch_plan, device), stream
    Kernel("rows_gather", "rows_gather", 5),
    # table, ids, rows, int64 scalars, stream
    Kernel("rows_write", "rows_write", 5),
    # g, ids, partials, grad, int64 scalars (N, V, D, lo, id bytes, the
    # plan of ops/embedding.py::bwd_plan, device), stream; a call is two
    # launches (the blocks' partials and their reduce), counted as one
    Kernel("embedding_bwd", "embedding_bwd_f32", 6),
    # gx, u, mask, hs, int64 scalars (B, T, H, device), stream
    Kernel("gru_scan_fwd", "gru_scan_fwd_f32", 6),
    # gx, u, mask, hs, dhs, dgx, ops, dh0, scalars, stream
    Kernel("gru_scan_bwd", "gru_scan_bwd_f32", 10),
    # x, u_rz, u_h, att, hs, hfin, scalars, stream
    Kernel("augru_scan_fwd", "augru_scan_fwd_f32", 8),
    # x, u_rz, u_h, att, hs, dhfin, dx, ops, datt, dh0, scalars, stream
    Kernel("augru_scan_bwd", "augru_scan_bwd_f32", 12),
)}

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
            lib.sparrow_error_string.argtypes = [ctypes.c_int]
            lib.sparrow_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch_counters() -> dict:
    """Every kernel of `TABLE` by name, each with `launches`, the calls of
    its own C entry point since it was last set to 0 (the narrow DIN
    kernels under `din_attention.narrow` and `din_attention_bwd.narrow`,
    bfloat16 FM under `fm_cross.bf16` and `fm_cross_bwd.bf16`)."""
    return {n: e for n, e in TABLE.items() if isinstance(e, Kernel)}


def launch_counts() -> dict:
    """{name: launches} of `launch_counters()`, a snapshot: the counters
    are live, so a test or a tool compares two snapshots, taken before
    and after what it runs."""
    return {n: k.launches for n, k in launch_counters().items()}


@functools.lru_cache(maxsize=4096)
def scalars(*ints: int):
    """A launch's int64 scalars as one `ctypes.c_int64` array, cached on
    the values, which a trainer or a server repeats call after call: a
    call then looks the array up, and ctypes converts one argument, not
    one an integer. The C side only reads it."""
    return (ctypes.c_int64 * len(ints))(*ints)


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().sparrow_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


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

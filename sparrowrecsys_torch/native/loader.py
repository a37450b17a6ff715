"""ctypes bindings for the C++ CSV loader: the port of
`sparrowrecsys_tpu/native/loader.py`.

`csv_loader.cc` beside this file is the package's own copy of the repo
root's `native/csv_loader.cc` (byte for byte). It is built at first use
with the host C++ compiler (`c++` or `g++`; `CXX_FLAGS`, no
`-march=native`, so the cached library carries no host-specific code)
into `sparrowrecsys_torch/_build/`, named by a hash of the source and the
flags, and written through a temporary file and `os.replace`, so several
processes may build at once.

The entry points fall back to the Python parse only where no C++
compiler is on the PATH, as the JAX package's fall back without a
toolchain; a compiler that fails raises with its output. `counts()`
records which parse each call ran.

The native parse is not correctly rounded (`parse_float` adds
digit * scale with scale *= 0.1), so a float field may differ from
Python's `float()` in the last bit before the float32 cast: the samples
and ratings agree exactly on the golden file, the embeddings to 1e-6
(the JAX package's own bounds). It rejects `nan` tokens, so an
embedding file of NaN rows (the shipped `itemGraphEmb.csv`) loads as no
rows here and as NaN rows through `artifacts.load_embeddings_csv`, as in
the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csv_loader.cc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_counts = {"native": 0, "python": 0}
#: Seconds the last build took; None when the library was cached.
build_seconds: Optional[float] = None


def counts() -> Dict[str, int]:
    """{"native": n, "python": n}: parses run by each path since the last
    `reset_counts()`."""
    return dict(_counts)


def reset_counts() -> None:
    for k in _counts:
        _counts[k] = 0


def compiler() -> Optional[str]:
    """The host C++ compiler on the PATH, or None."""
    return shutil.which("c++") or shutil.which("g++")


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsparrow_native-{h.hexdigest()[:16]}.so")


def build(cxx: str) -> str:
    """Compile `csv_loader.cc` with `cxx` unless the library for this
    source and these flags exists; returns its path. Raises
    `RuntimeError` with the compiler's output on failure."""
    global build_seconds
    so = library_path()
    if os.path.exists(so):
        build_seconds = None
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_so = os.path.join(tmp, "lib.so")
        out = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp_so, SOURCE],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {SOURCE}:\n{out.stdout}")
        os.replace(tmp_so, so)
    build_seconds = time.perf_counter() - t0
    return so


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32, i64, f32 = (np.ctypeslib.ndpointer(t) for t in (np.int32, np.int64, np.float32))
    lib.count_csv_rows.restype = ctypes.c_int64
    lib.count_csv_rows.argtypes = [ctypes.c_char_p]
    lib.load_ratings_csv.restype = ctypes.c_int64
    lib.load_ratings_csv.argtypes = [ctypes.c_char_p, i32, i32, f32, i64, ctypes.c_int64]
    lib.probe_embeddings.restype = ctypes.c_int64
    lib.probe_embeddings.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
    lib.load_embeddings.restype = ctypes.c_int64
    lib.load_embeddings.argtypes = [ctypes.c_char_p, i64, f32, ctypes.c_int64, ctypes.c_int64]
    lib.load_table_csv.restype = ctypes.c_int64
    lib.load_table_csv.argtypes = [ctypes.c_char_p, i32, ctypes.c_int64, ctypes.c_char_p,
                                   i32, f32, i32, i64, ctypes.c_int64]
    return lib


def _load_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None without a compiler."""
    global _lib
    if _lib is not None:
        return _lib
    cxx = compiler()
    if cxx is None:
        return None
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(build(cxx)))
    return _lib


def native_available() -> bool:
    return _load_lib() is not None


def _python(fn, path):
    _counts["python"] += 1
    return fn(path)


def load_ratings_native(path: str):
    """A `userId,movieId,rating,timestamp` CSV as `data.movielens.Ratings`;
    malformed rows are skipped."""
    from sparrowrecsys_torch.data.movielens import Ratings, load_ratings

    lib = _load_lib()
    if lib is None:
        return _python(load_ratings, path)
    cap = lib.count_csv_rows(path.encode())
    if cap < 0:
        raise FileNotFoundError(path)
    u = np.empty(cap, np.int32)
    m = np.empty(cap, np.int32)
    r = np.empty(cap, np.float32)
    t = np.empty(cap, np.int64)
    n = lib.load_ratings_csv(path.encode(), u, m, r, t, cap)
    if n < 0:  # the file vanished between the probe and the parse
        return _python(load_ratings, path)
    _counts["native"] += 1
    return Ratings(u[:n], m[:n], r[:n], t[:n])


#: Column kinds of `load_table_csv`: 1 int32, 2 float32, 3 genre, 4 int64.
_INT32 = ("movieId", "userId", "label", "releaseYear", "movieRatingCount",
          "userRatingCount", "userAvgReleaseYear")
_FLOAT32 = ("rating", "movieAvgRating", "movieRatingStddev", "userAvgRating",
            "userRatingStddev", "userReleaseYearStddev")


def load_samples_native(path: str):
    """A 27-column sample CSV as `data.schema.SampleTable`, column-equal to
    `data.dataset.load_samples_csv` in value and dtype."""
    from sparrowrecsys_torch.config import GENRE_VOCAB
    from sparrowrecsys_torch.data.dataset import load_samples_csv
    from sparrowrecsys_torch.data.schema import (
        GENRE_COLUMNS,
        HISTORY_COLUMNS,
        SAMPLE_COLUMNS,
        SampleTable,
    )

    lib = _load_lib()
    if lib is None:
        return _python(load_samples_csv, path)
    with open(path, encoding="utf-8") as f:
        header = f.readline().strip().split(",")
    if not set(SAMPLE_COLUMNS) <= set(header):
        return _python(load_samples_csv, path)

    kind_of = {c: 1 for c in _INT32 + tuple(HISTORY_COLUMNS)}
    kind_of.update({c: 2 for c in _FLOAT32})
    kind_of.update({c: 3 for c in GENRE_COLUMNS})
    kind_of["timestamp"] = 4
    kinds = np.array([kind_of.get(c, 0) for c in header], np.int32)
    cap = lib.count_csv_rows(path.encode())
    if cap < 0:
        raise FileNotFoundError(path)
    cap = max(cap, 1)
    # Column-major blocks, one per kind, in header order.
    by_kind = {k: [c for c in header if kind_of.get(c) == k] for k in (1, 2, 3, 4)}
    dtypes = {1: np.int32, 2: np.float32, 3: np.int32, 4: np.int64}
    blocks = {k: np.empty(len(cols) * cap, dtypes[k]) for k, cols in by_kind.items()}
    vocab = "\n".join(GENRE_VOCAB).encode()
    n = lib.load_table_csv(path.encode(), kinds, len(header), vocab,
                           blocks[1], blocks[2], blocks[3], blocks[4], cap)
    if n < 0:
        return _python(load_samples_csv, path)
    _counts["native"] += 1
    cols = {}
    for k, names in by_kind.items():
        for j, c in enumerate(names):
            cols[c] = blocks[k][j * cap:j * cap + n].copy()
    return SampleTable(cols)


def load_embeddings_native(path: str) -> Dict[int, np.ndarray]:
    """An `id:f f ...` embedding file as {id: float32 vector}; rows whose
    width differs from the first row's are skipped."""
    from sparrowrecsys_torch.embedding.artifacts import load_embeddings_csv

    lib = _load_lib()
    if lib is None:
        return _python(load_embeddings_csv, path)
    dim = ctypes.c_int64(0)
    rows = lib.probe_embeddings(path.encode(), ctypes.byref(dim))
    if rows < 0:
        raise FileNotFoundError(path)
    if rows == 0 or dim.value == 0:
        _counts["native"] += 1
        return {}
    ids = np.empty(rows, np.int64)
    matrix = np.empty((rows, dim.value), np.float32)
    n = lib.load_embeddings(path.encode(), ids, matrix.reshape(-1), rows, dim.value)
    if n < 0:
        return _python(load_embeddings_csv, path)
    _counts["native"] += 1
    return {int(ids[i]): matrix[i] for i in range(n)}

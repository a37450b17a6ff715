"""The loader's declaration table (`sparrowrecsys_torch/ops/kernels.py`).

Every C entry point of `csrc/*.cu` is declared once in `kernels.TABLE`,
by name, with its C parameter count; `launch_counters()` holds every kernel before
any op module is imported (the DIEN cell of `benchmark/` reads the four
scans' counters before it builds a model); and a declared kernel's call
appends the stream, raises on a CUDA error and counts. The call is run on
the CPU against a ctypes callback standing in for the library.
"""

import ctypes
import glob
import os
import re
import subprocess
import sys

import pytest
import torch

from sparrowrecsys_torch.ops import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCANS = ("gru_scan_fwd", "gru_scan_bwd", "augru_scan_fwd", "augru_scan_bwd")
_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def c_entry_points() -> dict:
    """{name: [its C parameters, one list per definition]} of every
    `extern "C" int` function in csrc/*.cu."""
    found: dict = {}
    for path in sorted(glob.glob(os.path.join(kernels.CSRC, "*.cu"))):
        with open(path) as f:
            for name, params in _ENTRY.findall(f.read()):
                found.setdefault(name, []).append([p for p in params.split(",") if p.strip()])
    return found


def test_the_table_holds_every_kernel_before_any_op_module_is_imported():
    """A fresh interpreter that imports the loader alone: every launching
    declaration is in `launch_counters()` (the four scans among them),
    each `launches` 0 and settable; no other module of `ops` is loaded."""
    code = (
        "import sys\n"
        "from sparrowrecsys_torch.ops import kernels\n"
        "c = kernels.launch_counters()\n"
        "launching = [n for n, e in kernels.TABLE.items() if isinstance(e, kernels.Kernel)]\n"
        "assert list(c) == launching, (list(c), launching)\n"
        f"assert all(n in c for n in {SCANS!r})\n"
        "assert all(k.launches == 0 for k in c.values())\n"
        "for k in c.values():\n"
        "    k.launches = 7\n"
        "assert set(kernels.launch_counts().values()) == {7}\n"
        "ops = sorted(m for m in sys.modules if m.startswith('sparrowrecsys_torch.ops.'))\n"
        "print(len(c), ops)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, ops = out.stdout.strip().split(" ", 1)
    assert int(n) == len(kernels.TABLE) - 1          # all but the backward's grid query
    assert ops == "['sparrowrecsys_torch.ops.kernels']"


def test_every_c_entry_point_is_declared_once():
    found = c_entry_points()
    declared = [e.entry for e in kernels.TABLE.values()]
    assert len(declared) == len(set(declared))
    assert sorted(declared) == sorted(found)
    assert all(name == e.name for name, e in kernels.TABLE.items())


@pytest.mark.parametrize("entry", kernels.TABLE.values(), ids=lambda e: e.entry)
def test_each_declaration_has_its_c_parameter_count(entry):
    """One definition in csrc/, whose parameters the declaration counts;
    a kernel's last parameter is the stream, a query takes none."""
    (params,) = c_entry_points()[entry.entry]
    assert len(params) == entry.n_args
    assert ("stream" in params[-1]) == isinstance(entry, kernels.Kernel)


def test_scalars_are_one_cached_int64_array_per_set_of_values():
    a = kernels.scalars(131072, 64, 10, 32, 64, 0)
    assert isinstance(a, ctypes.Array) and a._type_ is ctypes.c_int64
    assert list(a) == [131072, 64, 10, 32, 64, 0]
    assert kernels.scalars(131072, 64, 10, 32, 64, 0) is a
    assert kernels.scalars(131072, 64, 10, 32, 64, 1) is not a
    assert list(kernels.scalars(2 ** 40, -1)) == [2 ** 40, -1]


class _FakeLibrary:
    """The library's stand-in: `entry` a ctypes callback that records its
    arguments and returns the error code it is set to."""

    def __init__(self, n_args: int, err: int = 0):
        self.calls, self.err = [], err
        proto = ctypes.CFUNCTYPE(ctypes.c_int, *[ctypes.c_void_p] * n_args)
        self.entry = proto(self._record)

    def _record(self, *args):
        self.calls.append(args)
        return self.err

    @staticmethod
    def sparrow_error_string(err):
        return b"an error of the fake library"


@pytest.fixture
def fake_library(monkeypatch):
    def install(n_args, err=0):
        lib = _FakeLibrary(n_args, err)
        monkeypatch.setattr(kernels, "_lib", lib)
        # A CPU build of torch has no CUDA stream; stream 1000 + device here.
        monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda dev: 1000 + dev,
                            raising=False)
        return lib
    return install


def test_a_kernel_launches_on_the_devices_stream_and_counts(fake_library):
    lib = fake_library(4)
    k = kernels.Kernel("fake", "entry", 4)
    k(3, 11, 12, 13)
    k(0, 21, 22, 23)
    assert lib.calls == [(11, 12, 13, 1003), (21, 22, 23, 1000)]
    assert k.launches == 2
    assert lib.entry.argtypes == [ctypes.c_void_p] * 4 and lib.entry.restype is ctypes.c_int
    k.launches = 0
    k(1, 1, 2, 3)
    assert k.launches == 1
    assert k.stream(2) == 1002


def test_a_kernel_raises_on_a_cuda_error_and_does_not_count(fake_library):
    fake_library(3, err=700)
    k = kernels.Kernel("fake", "entry", 3)
    with pytest.raises(RuntimeError, match="fake: CUDA error 700: an error of the fake library"):
        k(0, 1, 2)
    assert k.launches == 0


def test_a_query_takes_no_stream_and_is_not_counted(fake_library):
    lib = fake_library(2)
    q = kernels.Query("fake.query", "entry", 2)
    q(5, 6)
    assert lib.calls == [(5, 6)]
    assert not hasattr(q, "launches")
    assert "fake.query" not in kernels.launch_counters()

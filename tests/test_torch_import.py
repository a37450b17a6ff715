"""The PyTorch port and chip_smoke.py import nothing of JAX, flax, msgpack or the JAX
package: the card's machine has none of them."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "sparrowrecsys_torch")
FORBIDDEN = ("jax", "flax", "msgpack", "sparrowrecsys_tpu")


def test_import_every_submodule_pulls_in_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sparrowrecsys_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "sparrowrecsys_torch.__path__, 'sparrowrecsys_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(names), ','.join(names), bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    n, names, bad = out.stdout.strip().split(" ", 2)
    assert int(n) >= 20, out.stdout
    for module in ("nearline.stream", "utils.profiling", "data.device_pipeline",
                   "serving.sidecar", "parallel", "parallel.mesh", "parallel.scaling",
                   "parallel.collectives", "tools.dist_bringup", "tools.dryrun_multichip",
                   "native", "native.loader", "tools.seq_signal", "tools.kernel_bench",
                   "tools.mfu_zoo"):
        assert f"sparrowrecsys_torch.{module}" in names.split(","), module
    assert bad == "[]", out.stdout


def test_no_source_file_imports_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|msgpack|sparrowrecsys_tpu)\b", re.M
    )
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    offenders = []
    for path in paths:
        with open(path) as fh:
            if pattern.search(fh.read()):
                offenders.append(os.path.relpath(path, REPO))
    assert len(paths) > 20
    assert offenders == []


def test_chip_smoke_imports_no_jax():
    """Importing chip_smoke (and running nothing) pulls in no JAX."""
    code = (
        "import sys\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_op_modules_launch_only_through_the_loaders_declarations():
    """The op modules launch through `ops/kernels.py`'s declarations: none
    calls the library, its error check or the stream lookup itself, or
    builds its own int64 scalars array (`kernels.scalars` does)."""
    pattern = re.compile(r"kernels\.library\(|kernels\.check\b|\bstream_of\b|c_int64\s*\*")
    offenders = {}
    for name in ("attention", "augru", "embedding", "fm", "rowio"):
        with open(os.path.join(PKG, "ops", f"{name}.py")) as fh:
            hits = pattern.findall(fh.read())
        if hits:
            offenders[name] = hits
    assert offenders == {}

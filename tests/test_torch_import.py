"""The PyTorch port imports nothing of JAX, flax, msgpack or the JAX package."""

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
        "print(len(names), bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 20, out.stdout
    assert bad == "[]", out.stdout


def test_no_source_file_imports_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|msgpack|sparrowrecsys_tpu)\b", re.M
    )
    offenders = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    if pattern.search(fh.read()):
                        offenders.append(os.path.relpath(path, REPO))
    assert offenders == []

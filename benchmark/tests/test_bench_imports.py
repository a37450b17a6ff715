"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program either: each loaded module's
top-level name, compared whole."""

from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys

from benchmark import harness
from benchmark.tests.tiny import REPO

PROGRAM = "sparrowrecsys_torch"


def _loaded(code: str) -> set:
    got = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    return set(json.loads(got.stdout.strip().splitlines()[-1]))


def test_whole_names_compared():
    saved = dict(sys.modules)
    try:
        sys.modules["jaxfoo"] = sys
        sys.modules["sparrowrecsys_tpux.a"] = sys
        assert harness.forbidden_modules() == []
        sys.modules["jax.numpy"] = sys
        assert harness.forbidden_modules() == ["jax.numpy"]
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]


def test_a_run_loads_no_jax(tmp_path):
    """Every module of the harness, the drivers and the readers imported,
    both cells run on the CPU, and the load generator and the knee and
    readings tools imported: no JAX, no JAX package."""
    code = (
        "import glob, importlib, io, os\n"
        "from benchmark import harness, knee, readings, faults, loadgen, run, trace\n"
        "from benchmark.tests.tiny import make_root, shrink\n"
        f"root = make_root({str(tmp_path / 'root')!r})\n"
        "shrink()\n"
        "for w in ('din_sparrow.train_long', 'din_sparrow.serve'):\n"
        "    harness.run_cell(root, w, 5, 1, True, device='cpu', stdout=io.StringIO(),"
        " stderr=io.StringIO())\n"
    )
    found = _loaded(code) & set(harness.FORBIDDEN)
    assert not found
    assert PROGRAM in _loaded(code)


def test_reference_loads_nothing_of_the_program():
    found = _loaded("import benchmark.reference.din, benchmark.reference.catalog")
    assert not found & (set(harness.FORBIDDEN) | {PROGRAM})


def test_reference_sources_import_nothing_of_the_program():
    for path in glob.glob(os.path.join(REPO, "benchmark", "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in set(harness.FORBIDDEN) | {PROGRAM, "benchmark"}, \
                    (path, n)

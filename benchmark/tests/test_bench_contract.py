"""The benchmark's contract, on the CPU: BENCHMARK.json's shape, the last
line of a run, cells found by name from files alone, and a machine
without a card refused.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.drivers import train_steps
from benchmark.tests.tiny import REPO, make_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return harness.load_json(os.path.join(REPO, "BENCHMARK.json"))


@pytest.fixture
def root(tmp_path):
    return make_root(str(tmp_path / "root"))


def run_cell(root, workload, trace=False, seconds=1, seed=2 ** 31 + 12345):
    out, err = io.StringIO(), io.StringIO()
    harness.run_cell(root, workload, seed, seconds, trace, device="cpu", stdout=out, stderr=err)
    return out.getvalue(), err.getvalue()


def test_benchmark_json_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and len(bench["command"]) <= 32
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["name"] for w in bench["workloads"]] + [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(REPO, c["file"]))
    configs = {c["name"] for c in bench["configs"]}
    assert configs == {w["config"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        traffic = harness.load_json(os.path.join(REPO, "benchmark", "traffic",
                                                 f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(REPO, "benchmark", "drivers",
                                           f"{traffic['kind']}.py"))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert os.path.exists(os.path.join(REPO, "benchmark", "metrics", f"{m['name']}.py"))
        for cell in m["workloads"]:
            assert harness.applies(e2e[m["moves"]], cell, [m["moves"]])


@pytest.mark.parametrize("workload", ["din_sparrow.train_long", "din_sparrow.serve"])
@pytest.mark.parametrize("trace", [False, True])
def test_last_line(root, workload, trace):
    out, err = run_cell(root, workload, trace)
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["attempted"] > 0
    bench = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    kinds = bench["per_layer"] if trace else bench["end_to_end"]
    want = {m["name"] for m in kinds if workload in m.get("workloads", [workload])}
    got = set(line["metrics"])
    assert got <= want and (got == want or trace)
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
    else:
        assert line["metrics"]["setup_s"]["value"] > 0
    checks = [ln for ln in err.strip().splitlines() if ln.startswith("[check]")]
    assert err.strip().splitlines()[-len(checks):] == checks
    assert len(checks) == len(line["checks"])


def test_cell_added_as_files_only(root):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as files and entries, with no code changed, run and report."""
    b = os.path.join(root, "benchmark")
    cfg = harness.load_json(os.path.join(b, "configs", "din_sparrow.json"))
    cfg.update({"name": "din_narrow", "dim": 4, "hidden": 8})
    with open(os.path.join(b, "configs", "din_narrow.json"), "w") as f:
        json.dump(cfg, f)
    traffic = harness.load_json(os.path.join(b, "traffic", "train_long.json"))
    traffic["batch"] = 128
    with open(os.path.join(b, "traffic", "train_small.json"), "w") as f:
        json.dump(traffic, f)
    shutil.copy(os.path.join(b, "limits", "din_sparrow.train_long.json"),
                os.path.join(b, "limits", "din_narrow.train_small.json"))
    with open(os.path.join(b, "metrics", "steps_traced.train_small.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx.values.get('traced_steps')\n")
    path = os.path.join(root, "BENCHMARK.json")
    bench = harness.load_json(path)
    bench["configs"].append({"name": "din_narrow", "source": "https://arxiv.org/abs/1706.06978",
                             "file": "benchmark/configs/din_narrow.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "din_narrow.train_small", "config": "din_narrow",
                               "traffic": "train_small", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("din_narrow.train_small")
    bench["per_layer"].append({"name": "steps_traced.train_small", "unit": "steps",
                               "better": "higher", "source": "program_counter", "layer": "test",
                               "moves": "train_examples_per_s",
                               "workloads": ["din_narrow.train_small"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    out, _ = run_cell(root, "din_narrow.train_small", trace=True)
    line = json.loads(out.strip().splitlines()[-1])
    assert line["metrics"]["steps_traced.train_small"]["value"] == train_steps.TRACE_STEPS
    out, _ = run_cell(root, "din_narrow.train_small")
    assert "train_examples_per_s" in json.loads(out.strip().splitlines()[-1])["metrics"]


def _command(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "din_sparrow.train_long", "--seed",
         str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    """On a machine without a card the measurement path exits non-zero and
    prints no result; it does not fall back to the CPU."""
    got = _command(REPO)
    assert got.returncode == 3 and got.stdout.strip() == ""
    assert "no CUDA card" in got.stderr


def test_benchmark_files_alone_fail(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's files alone, no
    program, gives no result."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    shutil.copytree(os.path.join(REPO, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = _command(str(tmp_path))
    assert got.returncode != 0 and got.stdout.strip() == ""


@pytest.mark.cuda
def test_cells_on_card(bench):
    """Each cell once on the card, short, with `correct` true."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for w in bench["workloads"]:
        got = subprocess.run(
            [sys.executable, "-m", "benchmark.run", "--workload", w["name"], "--seed",
             str(2 ** 31 + 99), "--seconds", "5", "--trace", "0"],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        assert got.returncode == 0, got.stderr[-2000:]
        assert json.loads(got.stdout.strip().splitlines()[-1])["correct"] is True

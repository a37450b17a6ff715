"""The frozen copies in benchmark/ agree with the originals they were
taken from, at the shapes of PERF.md's kernel table."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import costs, peaks
from benchmark.tests.tiny import REPO

SHAPES = [(8192, 5, 10, 32), (65536, 5, 10, 32), (65536, 64, 128, 32), (65536, 5, 128, 64)]


@pytest.mark.parametrize("b,t,d,h", SHAPES)
def test_din_costs(b, t, d, h):
    from sparrowrecsys_torch.tools import kernel_bench as kb

    for live in ((b * t, b), (b * t // 2, b // 3)):
        assert costs.din_attention_cost(b, t, d, h, *live) == \
            kb.din_attention_cost(b, t, d, h, *live)
        assert costs.din_attention_bwd_cost(b, t, d, h, *live) == \
            kb.din_attention_bwd_cost(b, t, d, h, *live)


@pytest.mark.parametrize("dim,hidden,t", [(10, 128, 5), (128, 1024, 64), (16, 32, 8)])
def test_din_flops(dim, hidden, t):
    from sparrowrecsys_torch.tools import mfu_zoo

    assert costs.din_flops_per_example(dim, hidden, t) == mfu_zoo.flops_per_example(
        "din", dim, hidden, t)


def test_peaks():
    from sparrowrecsys_torch.tools import kernel_bench as kb
    from sparrowrecsys_torch.tools import mfu_zoo

    assert peaks.HBM_BYTES_PER_S == mfu_zoo.HBM_BYTES_PER_S == kb.HBM_BYTES_PER_S
    assert peaks.TF32_FLOPS == kb.TC_F32_FLOPS * 3


def test_load_generator_agrees_with_the_original():
    """The copy and `tools/http_load.py`'s open loop, against one server at
    one rate: both answer every request and time it from its schedule."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import http_load
    finally:
        sys.path.pop(0)
    from sparrowrecsys_torch.serving.http import AsyncHTTPServer

    srv = AsyncHTTPServer(lambda path, q: (200, "application/json", b'[{"movieId": 7}]'),
                          port=0, host="127.0.0.1")
    srv.start()
    try:
        import time
        t0 = time.monotonic() + 0.5
        job = {"host": "127.0.0.1", "port": srv.port, "t0": t0, "drain_until": t0 + 10,
               "cores": None, "requests": [[k, k / 50, "/x"] for k in range(50)]}
        got = subprocess.run([sys.executable, "-m", "benchmark.loadgen"], input=json.dumps(job),
                             cwd=REPO, capture_output=True, text=True, timeout=60)
        rows = json.loads(got.stdout)["rows"]
        orig = http_load.run_open_loop(f"http://127.0.0.1:{srv.port}/x", 50, 1.0, procs=1)
    finally:
        srv.stop()
    assert sorted(r[0] for r in rows) == list(range(50))
    assert all(r[3] == 200 and r[4] == [7] and 0 < r[2] < 1 for r in rows)
    assert orig["requests"] == 50 and orig["errors"] == 0

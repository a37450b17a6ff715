"""`correct` comes out false under the control and under each fault a cell
can have, with the rest of a run driven as it is (on the CPU, the card
check skipped, at tiny sizes): the reference one precision step lower put
in the program's place; a step that leaves the state unchanged; half
the batch left out; an answer altered where it is produced."""

from __future__ import annotations

import io
import json

import pytest

from benchmark import faults, harness, readings
from benchmark.tests.tiny import make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("faults") / "root"))


def _run(root, workload, seed):
    out = io.StringIO()
    harness.run_cell(root, workload, seed, 1, False, device="cpu", stdout=out,
                     stderr=io.StringIO())
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload,fault", [
    ("din_sparrow.train_long", "unchanged_state"), ("din_sparrow.train_long", "half_batch"),
    ("din_sparrow.serve", "altered_answer")])
def test_fault_is_not_correct(root, workload, fault):
    with faults.FAULTS[fault]():
        line = _run(root, workload, 2 ** 32 + 11)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("workload", ["din_sparrow.train_long", "din_sparrow.serve"])
def test_sound_run_is_correct(root, workload):
    assert _run(root, workload, 2 ** 32 + 12)["correct"] is True


@pytest.mark.parametrize("workload", ["din_sparrow.train_long", "din_sparrow.serve"])
def test_control_fails_a_limit(root, workload):
    _, cell, config, traffic = harness.resolve(root, workload)
    reading = readings.serve_reading if "serve" in workload else readings.train_reading
    for seed in (2 ** 32 + 21, 2 ** 32 + 22, 2 ** 32 + 23):
        ctx = harness.Context(root=root, cell=cell, config=config, traffic=traffic, seed=seed,
                              seconds=1, trace=False, device="cpu")
        got = reading(ctx, "control")
        assert any(got[k] > v for k, v in harness.limits_of(root, workload).items()), got

"""`sparrowrecsys_torch/utils/profiling.py` against the JAX package's
`utils/profiling.py`: `StepTimer` gives JAX's readings under the same
patched clock, and `trace()` writes a Chrome trace of what ran."""

import glob
import json
import os

import pytest
import torch

import sparrowrecsys_torch.utils as tutils
from sparrowrecsys_torch.utils import profiling as tprof
from sparrowrecsys_tpu.utils import profiling as jprof

torch.set_num_threads(2)

#: Host clock readings: uneven steps, a stall, then steady steps.
TICKS = [10.0, 10.5, 10.75, 13.0, 13.125, 13.25, 13.375, 13.5]


class _Clock:
    def __init__(self, readings):
        self.readings = list(readings)

    def __call__(self):
        return self.readings.pop(0)


@pytest.mark.parametrize("ema", [0.98, 0.5, 0.0])
def test_step_timer_reads_as_jax_under_one_clock(monkeypatch, ema):
    timers = []
    for mod in (tprof, jprof):
        monkeypatch.setattr(mod.time, "perf_counter", _Clock(TICKS))
        t = mod.StepTimer(batch_size=4096, ema=ema)
        assert t.examples_per_sec == 0.0
        for _ in TICKS:
            t.tick()
        timers.append(t)
        monkeypatch.undo()
    port, ref = timers
    assert port.steps == ref.steps == len(TICKS)
    assert port.step_time == ref.step_time
    assert port.examples_per_sec == ref.examples_per_sec > 0


def test_mark_sync_restarts_the_step_clock(monkeypatch):
    monkeypatch.setattr(tprof.time, "perf_counter", _Clock([1.0, 2.0, 5.0, 5.25]))
    t = tprof.StepTimer(batch_size=10, ema=0.0)
    t.tick()
    t.tick()
    t.mark_sync({"loss": torch.ones(3), "n": 2})  # host tensors: nothing to wait for
    t.tick()
    assert t.step_time == 0.25 and t.examples_per_sec == 40.0


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with tprof.trace(log_dir):
        x = torch.ones(64, 64) @ torch.ones(64, 64)
    assert float(x[0, 0]) == 64.0
    (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_utils_exports_what_jax_utils_exports():
    assert tutils.StepTimer is tprof.StepTimer and tutils.trace is tprof.trace
    assert callable(tutils.get_registry) and tutils.MetricsRegistry

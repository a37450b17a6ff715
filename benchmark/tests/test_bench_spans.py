"""The readers of the program's spans (`forward_ms.train`,
`backward_ms.train`, `optimizer_ms.train`, `embedding_bwd_ms.train`,
`backward_idle_ms.train`, `host_syncs_per_step.train`) over a hand-built
Chrome trace of two training steps: a main thread holds the `trainer.*`
ranges, and an autograd thread launches the backward's kernels, as on the
card."""

from __future__ import annotations

import types

import pytest

from benchmark import harness
from benchmark.tests.tiny import REPO
from benchmark.trace import Trace

READERS = ("forward_ms.train", "backward_ms.train", "optimizer_ms.train",
           "embedding_bwd_ms.train", "backward_idle_ms.train", "host_syncs_per_step.train")
MAIN, AUTOGRAD = 1, 2
STEP_US = 400.0


def _host(name, ts, dur, tid=MAIN, cat="user_annotation", **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def _launch(ts, corr, tid=MAIN, cat="cuda_runtime", name="cudaLaunchKernel"):
    return _host(name, ts, 4.0, tid=tid, cat=cat, correlation=corr)


def _kernel(ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"k{corr}", "ts": ts, "dur": dur, "pid": 0,
            "tid": 7, "args": {"correlation": corr}}


def _step(k: int, syncs) -> list:
    """Step k (0-based): forward [20, 100], backward [110, 300] with an
    `embedding.backward` [200, 262] on the autograd thread, optimizer
    [310, 380], each offset by k * STEP_US; `syncs` are (name, time)
    runtime calls inside the step."""
    o, c = k * STEP_US, 10 * k
    ev = [_host("trainer.step", o + 10, 380), _host("trainer.forward", o + 20, 80),
          _host("trainer.backward", o + 110, 190), _host("trainer.optimizer", o + 310, 70),
          # forward: launched on the main thread, 50 us on the device
          _launch(o + 30, c + 1), _kernel(o + 40, 50, c + 1),
          # backward: launched on the autograd thread, 100 + 30 us; the
          # second inside the autograd thread's embedding.backward
          _launch(o + 120, c + 2, tid=AUTOGRAD), _kernel(o + 150, 100, c + 2),
          _host("embedding.backward", o + 200, 62, tid=AUTOGRAD),
          _launch(o + 210, c + 3, tid=AUTOGRAD), _kernel(o + 260, 30, c + 3, cat="gpu_memset"),
          # optimizer: a driver-API launch, 20 us
          _launch(o + 320, c + 4, cat="cuda_driver", name="cuLaunchKernel"),
          _kernel(o + 330, 20, c + 4),
          # runtime calls that are no synchronise
          _host("cudaMemcpyAsync", o + 240, 3, tid=AUTOGRAD, cat="cuda_runtime"),
          _host("cudaStreamWaitEvent", o + 330, 1, cat="cuda_runtime")]
    ev += [_host(name, o + t, 2, tid=AUTOGRAD, cat="cuda_runtime") for name, t in syncs]
    return ev


def _trace(outside_us=10.0, spans=True, device=True) -> Trace:
    ev = [_host("bench.window", 0, 1000)]
    ev += _step(0, [("cudaStreamSynchronize", 270), ("cudaEventSynchronize", 290)])
    ev += _step(1, [("cudaDeviceSynchronize", 150)])
    # outside every span: a launch and a synchronise between the steps
    ev += [_launch(402, 99), _kernel(404, outside_us, 99),
           _host("cudaDeviceSynchronize", 403, 1, cat="cuda_runtime")]
    if not spans:
        ev = [e for e in ev if not e["name"].startswith(("trainer.", "embedding."))]
    if not device:
        ev = [e for e in ev if e["cat"] not in ("kernel", "gpu_memset")]
    return Trace(ev)


def _read(name: str, tr: Trace):
    return harness.load_reader(REPO, name)(types.SimpleNamespace(device_trace=tr))


def test_readings_of_two_steps():
    got = {name: _read(name, _trace()) for name in READERS}
    assert got == pytest.approx({
        "forward_ms.train": 0.050, "backward_ms.train": 0.130, "optimizer_ms.train": 0.020,
        "embedding_bwd_ms.train": 0.030,
        # backward's 190 us less the 100 + 30 us its kernels cover
        "backward_idle_ms.train": 0.060,
        # three of the three synchronise names over two steps
        "host_syncs_per_step.train": 1.5})


def test_backward_kernels_launched_on_another_thread_count():
    """The benchmark's own same-thread reading sees none of them; the
    span reader sees both."""
    tr = _trace()
    assert tr.range_device_s("trainer.backward") == (0.0, 2)
    assert _read("backward_ms.train", tr) == pytest.approx(0.130)


def test_kernels_outside_every_span_count_nowhere():
    short, long = _trace(outside_us=10.0), _trace(outside_us=90.0)
    for name in READERS:
        assert _read(name, short) == _read(name, long), name


def test_idle_outside_the_backward_is_left_out():
    """A device event that fills the forward's idle time leaves the
    backward's idle as it was; one inside the backward's gap shrinks it."""
    base = _trace()
    fwd = Trace(base.device + base.host + [_kernel(95, 10, 50)])
    bwd = Trace(base.device + base.host + [_kernel(110, 40, 51)])
    assert _read("backward_idle_ms.train", fwd) == pytest.approx(0.060)
    assert _read("backward_idle_ms.train", bwd) == pytest.approx(0.040)


@pytest.mark.parametrize("spans, device", [(False, True), (True, False), (False, False)])
def test_no_step_or_no_device_reads_nothing(spans, device):
    tr = _trace(spans=spans, device=device)
    for name in READERS:
        assert _read(name, tr) is None, name
    assert all(_read(name, None) is None for name in READERS)

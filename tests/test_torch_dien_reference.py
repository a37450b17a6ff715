"""The port's DIEN against the plain reference (`reference/dien.py`) on the
CPU, and the benchmark's DIEN cell (`dien_sparrow.train_long`) at a CPU
size.

The program (`models/dien.py` through `Trainer._train_step` with
`dien_loss_fn`, the plain recurrence path the CPU takes) and the reference
start from the same seeded weights (`benchmark/weights_dien.py`) at B = 64,
T = 7 with masked history steps, D = 10, and are held to each other on the
logits, the aux scores, the objective, every gradient and the parameters
after 3 Adam steps. Tolerances, float32 on both sides, the same arithmetic
grouped differently (the program's projections are one product over the
stacked steps, the reference's products are per step):
- logits, aux and the objective: 1e-5 of their scale;
- gradients: 1e-4 of each one's scale (sums of 64 rows and 7 steps in
  another order);
- the parameters after 3 steps: 1e-6 absolute, under a thousandth of
  Adam's step of 1e-3, except where a gradient element is at the
  round-off of its leaf (1e-5 of the leaf's largest), whose sign Adam
  turns into a whole step either way.
No JAX here: the JAX package's DIEN is held to the port in
test_torch_dien.py.
"""

import filecmp
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import costs_dien, harness, weights_dien
from benchmark.drivers import dien_train_steps as drv
from reference import dien as ref
from sparrowrecsys_torch.config import TrainConfig
from sparrowrecsys_torch.models import build_model
from sparrowrecsys_torch.models.dien import dien_loss_fn
from sparrowrecsys_torch.training.checkpoint import flax_layout
from sparrowrecsys_torch.training.loop import Trainer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "dien_sparrow.train_long"
B, T = 64, 7
CFG = {"dim": 10, "hidden": 16, "user_buckets": 50, "movie_buckets": 40,
       "numeric_scale": {"userRatingCount": 10, "userAvgRating": 5, "userRatingStddev": 1,
                         "releaseYear": 2000, "movieRatingCount": 100, "movieAvgRating": 5,
                         "movieRatingStddev": 1}}
OPT = {"learning_rate": 1e-3, "adam_b1": 0.9, "adam_b2": 0.999, "adam_eps": 1e-7}


def _close(got, want, rel, what):
    got, want = got.detach().double(), want.detach().double()
    scale = max(float(want.abs().max()), 1e-12)
    err = float((got - want).abs().max())
    assert err <= rel * scale, f"{what}: max error {err} against {rel} of {scale}"


def _batches(seed, n=3):
    """n batches of B rows, a quarter of them with only the first 4 history
    steps (ids 0 after), their negatives as the benchmark makes them."""
    feats, labels = weights_dien.train_columns(
        CFG, {"history": T, "movie_zipf_s": 1.0, "label_p": 0.5}, seed, "cpu", n * B)
    for k in range(5, T + 1):
        feats[f"userRatedMovie{k}"][::4] = 0
    return [({k: v[i * B:(i + 1) * B] for k, v in feats.items()}, labels[i * B:(i + 1) * B])
            for i in range(n)]


@pytest.fixture(scope="module")
def setup():
    w0 = weights_dien.make_dien(CFG, 2 ** 33 + 17, "cpu")
    model = build_model("dien", dim=10, movie_buckets=40, user_buckets=50, hidden=16,
                        recent_movies=T)
    names = {k: ("/".join(p), t) for k, (p, t) in flax_layout(model).items()}
    return w0, model, names, _batches(5)


def _program_params(w0, names):
    return {k: (w0[n].T if t else w0[n]).clone() for k, (n, t) in names.items()}


def test_names_and_shapes_are_the_models(setup):
    w0, model, names, _ = setup
    assert sorted(n for n, _ in names.values()) == sorted(w0)
    state = model.state_dict()
    for k, (n, t) in names.items():
        assert tuple((w0[n].T if t else w0[n]).shape) == tuple(state[k].shape), k


def test_forward_matches_the_reference(setup):
    w0, model, names, batches = setup
    feats, _ = batches[0]
    model.load_state_dict(_program_params(w0, names))
    with torch.no_grad():
        logits, aux = model(feats)
        want_logits, want_aux = ref.forward(w0, feats, T)
    _close(logits, want_logits, 1e-5, "logits")
    _close(aux, want_aux, 1e-5, "aux")


def test_objective_gradients_and_three_adam_steps_match_the_reference(setup):
    w0, model, names, batches = setup
    trainer = Trainer(model, TrainConfig(batch_size=B, epochs=1), device="cpu",
                      loss_fn=dien_loss_fn(alpha=0.5, recent_movies=T, movie_vocab=40))
    params, opt_state = trainer.prepare(_program_params(w0, names))
    feats, labels = batches[0]
    _, loss, _, grads = trainer.loss_and_grads(params, opt_state, feats, labels, torch.ones(B))
    want_loss, want_grads = ref.loss_and_grads(w0, feats, labels, T, 0.5)
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    for k, (n, t) in names.items():
        _close(grads[k].T if t else grads[k], want_grads[n], 1e-4, n)

    from sparrowrecsys_torch.ops import metrics as M

    mstate = M.init_metrics("cpu")
    for f, y in batches:
        params, opt_state, mstate = trainer._train_step(params, opt_state, mstate, f, y,
                                                        torch.ones(B))
    w = {k: v.clone() for k, v in w0.items()}
    adam = ref.Adam(w, OPT["learning_rate"], OPT["adam_b1"], OPT["adam_b2"], OPT["adam_eps"])
    for f, y in batches:
        _, g = ref.loss_and_grads(w, f, y, T, 0.5)
        adam.step(w, g)
    for k, (n, t) in names.items():
        got = params[k].T if t else params[k]
        noisy = want_grads[n].abs() <= 1e-5 * want_grads[n].abs().max()
        err = (got - w[n]).abs().masked_fill(noisy, 0.0)
        assert float(err.max()) <= 1e-6, (n, float(err.max()))


def test_lower_precision_rounds_every_product_to_tf32(setup):
    w0, _, _, batches = setup
    feats, _ = batches[0]
    x = torch.tensor([1.0 + 2 ** -12, 3.0 + 2 ** -20])
    assert torch.equal(ref._lowered(x), torch.tensor([1.0, 3.0]))
    with torch.no_grad():
        stated, lowered = ref.forward(w0, feats, T)[0], ref.forward(w0, feats, T, "lower")[0]
    gap = float((stated - lowered).abs().max() / stated.abs().max())
    assert 1e-6 < gap < 1e-2


def test_the_frozen_copy_is_the_reference():
    assert filecmp.cmp(os.path.join(REPO, "reference", "dien.py"),
                       os.path.join(REPO, "benchmark", "reference", "dien.py"), shallow=False)


@pytest.mark.parametrize("b,t,h", [(131072, 64, 10), (65536, 5, 10), (33, 7, 32)])
def test_scan_costs_are_kernel_benchs(b, t, h):
    from sparrowrecsys_torch.tools import kernel_bench as kb

    for live in (b * t, b * t // 3):
        assert costs_dien.gru_scan_cost(b, t, h, live) == kb.gru_scan_cost(b, t, h, live)
        assert costs_dien.gru_scan_bwd_cost(b, t, h, live) == kb.gru_scan_bwd_cost(b, t, h, live)
    assert costs_dien.augru_scan_cost(b, t, h) == kb.augru_scan_cost(b, t, h)
    assert costs_dien.augru_scan_bwd_cost(b, t, h) == kb.augru_scan_bwd_cost(b, t, h)
    fwd = costs_dien.rnn_fwd_cost(b, t, h, 32, b * t, b)
    assert fwd[0] == (kb.gru_scan_cost(b, t, h, b * t)[0] + kb.augru_scan_cost(b, t, h)[0]) / 2


def test_flops_per_example_counts_each_layer():
    """DIEN.py's layers at D = 10, T = 64, tower 128, heads 32: the GRU and
    AUGRU 6 D^2 a step each, the attention 32 D + 32 a step, the tower
    57 x 128 + 128 x 64 + 64, the heads 2 x (20 x 32 + 32) over 63 steps."""
    macs = 64 * 600 + 64 * 352 + 64 * 600 + (57 * 128 + 128 * 64 + 64) + 63 * 2 * 672
    assert costs_dien.dien_flops_per_example(10, 128, 64) == 2.0 * macs


def test_benchmark_entries_of_the_cell():
    bench = harness.load_json(os.path.join(REPO, "BENCHMARK.json"))
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    assert config["reduced"] == [] and len(config["why"]) <= 200
    cfg = harness.load_json(os.path.join(REPO, config["file"]))
    assert (cfg["dim"], cfg["gru_hidden"], cfg["augru_hidden"], cfg["attention_hidden"],
            cfg["aux_hidden"], cfg["hidden"]) == (10, 10, 10, 32, 32, 128)
    reads = {m["name"] for m in bench["per_layer"] if CELL in m.get("workloads", [])}
    assert {"recurrence_ms.train", "recurrence_fwd_roofline.train",
            "recurrence_bwd_roofline.train", "train_mfu", "backward_ms.train"} <= reads
    assert not {"din_fwd_roofline.train", "din_bwd_roofline.train"} & reads
    limits = harness.limits_of(REPO, CELL)
    assert set(limits) == {"loss_gap", "grad1_gap", "change_gap", "grad1_median_gap",
                           "small_grad1_gap", "small_change_gap"}


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    """A benchmark root whose DIEN traffic is cut to 64 rows and 8 steps."""
    from benchmark.tests.tiny import make_root

    root = make_root(str(tmp_path_factory.mktemp("dien") / "root"))
    path = os.path.join(root, "benchmark", "traffic", "train_long_dien.json")
    traffic = harness.load_json(path)
    traffic.update({"batch": 64, "history": 8})
    with open(path, "w") as f:
        json.dump(traffic, f)
    return root


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_and_is_correct_on_the_cpu(small_root, trace):
    """The cell through the harness on the CPU, in a process of its own
    (this one has loaded JAX, which a run refuses), the drivers' pools and
    traced steps cut to CPU sizes."""
    code = (
        "import io, json, sys\n"
        "from benchmark import harness\n"
        "from benchmark.drivers import train_steps\n"
        "train_steps.POOL_BATCHES, train_steps.TRACE_STEPS = 4, 2\n"
        "out, err = io.StringIO(), io.StringIO()\n"
        f"harness.run_cell({small_root!r}, {CELL!r}, 2 ** 31 + 12345, 1, {trace}, device='cpu',"
        " stdout=out, stderr=err)\n"
        "print(out.getvalue().strip().splitlines()[-1])\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    got = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=600)
    assert got.returncode == 0, got.stderr[-3000:]
    line = json.loads(got.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == {"loss_gap", "grad1_gap", "change_gap", "grad1_median_gap",
                                   "small_grad1_gap", "small_change_gap"}
    if trace:
        assert "train_mfu" in line["metrics"] and "breakdown" in line
    else:
        assert set(line["metrics"]) == {"train_examples_per_s", "setup_s"}


def test_ranges_wrap_the_recurrences_and_leave_them_as_they_were(setup):
    """The benchmark's `bench.rnn_*` ranges: one forward and one backward
    range a recurrence a step, the gradients unchanged."""
    from torch.profiler import ProfilerActivity, profile

    from sparrowrecsys_torch.ops import augru

    w0, model, names, batches = setup
    feats, labels = batches[0]
    leaves = {k: v.requires_grad_() for k, v in _program_params(w0, names).items()}
    loss_fn = dien_loss_fn(recent_movies=T, movie_vocab=40)

    def grads():
        loss, _ = loss_fn(lambda p, f: torch.func.functional_call(model, p, (f,)), leaves, feats,
                          labels, torch.ones(B))
        return torch.autograd.grad(loss, list(leaves.values()))

    real = (augru.gru_recurrence, augru.augru_recurrence)
    with profile(activities=[ProfilerActivity.CPU]) as prof, drv.RnnRanges():
        ranged = grads()
    assert (augru.gru_recurrence, augru.augru_recurrence) == real
    counts = {}
    for e in prof.events():
        if e.name.startswith("bench.rnn_"):
            counts[e.name] = counts.get(e.name, 0) + 1
    assert counts == {"bench.rnn_fwd": 2, "bench.rnn_bwd": 2}
    for g, r in zip(ranged, grads()):
        assert torch.equal(g, r)


def test_readers_find_nothing_without_a_device_trace():
    """A run without the program's spans or a device trace (the parent,
    the CPU) reads None from the new readers, and raises nothing."""
    ctx = harness.Context(root=REPO, cell={"name": CELL}, config={}, traffic={}, seed=1,
                          seconds=1, trace=True)
    ctx.values.update({"batch": 8, "t": 4, "dim": 10, "att": 32, "live_steps": 32,
                       "live_rows": 8})
    for name in ("recurrence_ms.train", "recurrence_fwd_roofline.train",
                 "recurrence_bwd_roofline.train"):
        assert harness.load_reader(REPO, name)(ctx) is None
    assert np.isfinite(costs_dien.rnn_bwd_cost(8, 4, 10, 32, 32, 8)[0])


@pytest.mark.parametrize("lacks", [drv.SCANS, ("augru_scan_bwd",)])
def test_a_program_without_the_scans_cannot_run_the_cell(monkeypatch, lacks):
    """A program whose launch counters lack a scan (recurrences as per-step
    loops) is refused before the cell builds anything."""
    from sparrowrecsys_torch.ops import kernels

    real = kernels.launch_counters
    monkeypatch.setattr(kernels, "launch_counters",
                        lambda: {k: v for k, v in real().items() if k not in lacks})
    built = []
    monkeypatch.setattr(drv, "Job", built.append)
    ctx = harness.Context(root=REPO, cell={"name": CELL}, config={}, traffic={}, seed=1,
                          seconds=1, trace=False, device="cpu")
    with pytest.raises(drv.CannotRun, match=lacks[-1]):
        drv.run(ctx)
    assert not built


def test_the_checked_steps_must_run_every_scan_each_step():
    """The program has the four scans; steps that launch one of them fewer
    times than there were steps are refused."""
    scans = drv.scan_counters()
    assert tuple(scans) == drv.SCANS and all(hasattr(fn, "launches") for fn in scans.values())
    fake = {n: type(n, (), {"launches": 5})() for n in drv.SCANS}
    before = {n: 2 for n in drv.SCANS}
    assert drv.scans_ran(fake, before, 3) == {n: 3 for n in drv.SCANS}
    fake["augru_scan_fwd"].launches = 4
    with pytest.raises(drv.CannotRun, match="'augru_scan_fwd': 2"):
        drv.scans_ran(fake, before, 3)

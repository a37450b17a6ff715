"""The training step as one CUDA graph (`training/step_graph.py`,
`Trainer._train_step`) against the eager step.

On the CPU: the metric thresholds are one tensor a device; the step never
captures; the rules by which a step may take the graph; and the graph's
bookkeeping (warm-up, capture, replay, the batch and metric state copied
in, the states written back, foreign state, a profiled step, another
shape, a two-epoch fit), with a stand-in for the capture that runs the
captured body eagerly on the graph's own buffers, bit for bit against an
eager twin. On the card (`cuda` marker) the same with the real graph, at
the benchmark cells' widths. This file imports no JAX, so the card's
machine runs it without the JAX package's conftest:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_step_graph.py
"""

import copy
import gc
import json
import os
import types
import weakref

import pytest
import torch

from sparrowrecsys_torch.config import TrainConfig
from sparrowrecsys_torch.data.dataset import EncodedDataset
from sparrowrecsys_torch.data.synthetic import synthetic_ctr_dataset
from sparrowrecsys_torch.models import build_model
from sparrowrecsys_torch.ops import metrics as M
from sparrowrecsys_torch.training import loop, step_graph
from sparrowrecsys_torch.training.loop import GRAPH_WARMUP_STEPS, Trainer
from sparrowrecsys_torch.training.step_graph import leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 32


def _counts(eager=0, captured=0, replayed=0):
    return {"eager": eager, "captured": captured, "replayed": replayed}


def _equal(a, b) -> bool:
    a, b = leaves(a), leaves(b)
    return len(a) == len(b) > 0 and all(torch.equal(x, y) for x, y in zip(a, b))


# ---- the CPU ------------------------------------------------------------------


class EagerCapture(step_graph.StepGraph):
    """A StepGraph whose 'capture' records nothing: its replay runs the
    captured body (the step on the graph's buffers and states, and the
    write-back) eagerly."""

    def _capture(self, step, stream):
        return types.SimpleNamespace(replay=lambda: self._body(step))


def _din_trainer(batch=BATCH):
    model = build_model("din", dim=4, attention_hidden=8, hidden=16)
    return Trainer(model, TrainConfig(batch_size=batch, epochs=2), device="cpu")


def _as_card(trainer, monkeypatch):
    """The trainer takes the graph by the card's rules, on the CPU: the
    stand-in capture, and the warm-up's stream the current one."""
    monkeypatch.setattr(loop, "StepGraph", EagerCapture)
    monkeypatch.setattr(trainer, "_graphable", lambda generator: generator is None and
                        not torch.autograd.profiler._is_profiler_enabled)
    monkeypatch.setattr(trainer, "_step_on_capture_stream", trainer._step)
    return trainer


def _din_batches(n, rows=BATCH):
    out = []
    for i in range(n):
        ds = synthetic_ctr_dataset(rows, seed=10 + i)
        out.append(({k: torch.as_tensor(v) for k, v in ds.features.items()},
                    torch.as_tensor(ds.labels), torch.ones(rows)))
    return out


@pytest.fixture
def twins(monkeypatch):
    """(graph trainer, its state, eager trainer, its state): the same model
    and initial params."""
    trainers = [_din_trainer(), _din_trainer()]
    _as_card(trainers[0], monkeypatch)
    init = trainers[0].init_params(seed=1)
    states = [list(t.prepare(init)) + [M.init_metrics("cpu")] for t in trainers]
    return trainers[0], states[0], trainers[1], states[1]


def _run(trainer, state, batch):
    return list(trainer._train_step(*state, *batch))


def test_thresholds_are_one_tensor_a_device():
    th = M._thresholds("cpu")
    assert M._thresholds(torch.device("cpu")) is th
    assert torch.equal(th, M._thresholds_on.__wrapped__(torch.device("cpu")))
    assert th.shape == (M.NUM_THRESHOLDS,) and th[0] < 0 and th[-1] > 1


def test_the_cpu_never_captures():
    trainer = _din_trainer()
    params, opt = trainer.prepare(trainer.init_params(seed=1))
    state = [params, opt, M.init_metrics("cpu")]
    for batch in _din_batches(2) * 3:
        state = _run(trainer, state, batch)
    assert trainer.step_counts() == _counts(eager=6)
    assert trainer._graph is None and int(state[1].count) == 6


@pytest.mark.parametrize("case", ["card", "cpu", "plan", "sparse", "generator", "profiler"])
def test_which_steps_may_take_the_graph(case):
    sparse = {"emb_userId": ("userId",)} if case == "sparse" else None
    trainer = Trainer(build_model("din", dim=4, attention_hidden=8, hidden=16),
                      TrainConfig(batch_size=BATCH), sparse_tables=sparse, device="cpu")
    if case != "cpu":
        trainer.device = torch.device("cuda")
    if case == "plan":
        trainer.plan = object()
    generator = torch.Generator() if case == "generator" else None
    if case == "profiler":
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            assert not trainer._graphable(generator)
    else:
        assert trainer._graphable(generator) == (case == "card")


def test_replayed_steps_equal_eager_ones(twins):
    """12 steps cycling 4 batches, a fresh metric state after step 6: warm-up,
    capture, replays; the params, the Adam state (count 12) and the metric
    state bit for bit those of the eager twin."""
    graph_trainer, gs, eager_trainer, es = twins
    batches = _din_batches(4)
    for i in range(12):
        if i == 6:
            gs[2], es[2] = M.init_metrics("cpu"), M.init_metrics("cpu")
        gs = _run(graph_trainer, gs, batches[i % 4])
        es = _run(eager_trainer, es, batches[i % 4])
        assert _equal(gs, es), f"step {i + 1}"
    w = GRAPH_WARMUP_STEPS
    assert graph_trainer.step_counts() == _counts(eager=w, captured=1, replayed=11 - w)
    assert eager_trainer.step_counts() == _counts(eager=12)
    assert int(gs[1].count) == 12
    graph = graph_trainer._graph
    assert gs[1] is graph.opt_state and gs[2] is graph.mstate and graph.holds(gs[0], gs[1])


def _warm(trainer, state, batches):
    for i in range(GRAPH_WARMUP_STEPS + 2):
        state = _run(trainer, state, batches[i % len(batches)])
    assert trainer.step_counts() == _counts(eager=GRAPH_WARMUP_STEPS, captured=1, replayed=1)
    return state


def test_a_step_on_foreign_state_runs_eagerly_and_recaptures(twins):
    graph_trainer, gs, eager_trainer, es = twins
    batches = _din_batches(2)
    gs = _warm(graph_trainer, gs, batches)
    first = graph_trainer._graph
    w = GRAPH_WARMUP_STEPS
    foreign = copy.deepcopy(gs)
    for j in range(w + 1):
        foreign = _run(graph_trainer, foreign, batches[(w + 2 + j) % 2])
        if j == 0:
            assert graph_trainer._graph is None
            assert graph_trainer.step_counts() == _counts(eager=w + 1, captured=1, replayed=1)
    assert graph_trainer.step_counts() == _counts(eager=2 * w, captured=2, replayed=1)
    assert graph_trainer._graph is not first and graph_trainer._graph.holds(*foreign[:2])
    for i in range(2 * w + 3):
        es = _run(eager_trainer, es, batches[i % 2])
    assert _equal(foreign, es)


def test_a_profiled_step_runs_eagerly_and_keeps_the_graph(twins, tmp_path):
    import sparrowrecsys_torch.utils as tutils

    graph_trainer, gs, eager_trainer, es = twins
    batches = _din_batches(2)
    gs = _warm(graph_trainer, gs, batches)
    graph = graph_trainer._graph
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        gs = _run(graph_trainer, gs, batches[1])
    names = {e.name for e in prof.events()}
    assert {"trainer.step", "trainer.forward", "trainer.backward", "trainer.optimizer"} <= names
    w = GRAPH_WARMUP_STEPS
    assert graph_trainer.step_counts() == _counts(eager=w + 1, captured=1, replayed=1)
    assert graph_trainer._graph is graph and gs[1] is graph.opt_state
    with tutils.trace(str(tmp_path)):
        gs = _run(graph_trainer, gs, batches[0])
    gs = _run(graph_trainer, gs, batches[1])
    assert graph_trainer.step_counts() == _counts(eager=w + 2, captured=1, replayed=2)
    for i in range(w + 5):
        es = _run(eager_trainer, es, batches[i % 2])
    assert _equal(gs, es)


def test_a_batch_of_another_shape_runs_eagerly(twins):
    graph_trainer, gs, eager_trainer, es = twins
    batches = _din_batches(2)
    gs = _warm(graph_trainer, gs, batches)
    graph = graph_trainer._graph
    short = _din_batches(1, rows=BATCH // 2)[0]
    other = ({**batches[0][0], "movieId": batches[0][0]["movieId"].long()},) + batches[0][1:]
    for batch in (short, other):
        assert not graph.fits(*batch)
        gs = _run(graph_trainer, gs, batch)
    gs = _run(graph_trainer, gs, batches[1])
    w = GRAPH_WARMUP_STEPS
    assert graph_trainer.step_counts() == _counts(eager=w + 2, captured=1, replayed=2)
    assert graph_trainer._graph is graph
    for batch in batches * 2 + [batches[0], short, other, batches[1]]:
        es = _run(eager_trainer, es, batch)
    assert _equal(gs, es)


def test_a_trainer_and_its_graph_hold_no_cycle(monkeypatch):
    """With the cycle collector off, a dropped trainer and its graph are
    freed at once: the graph keeps no reference to its trainer."""

    class NoCapture(step_graph.StepGraph):
        def _capture(self, step, stream):
            return types.SimpleNamespace(replay=lambda: None)

    # Patched on the class: a bound method set on the trainer would be a
    # cycle of the test's own.
    monkeypatch.setattr(loop, "StepGraph", NoCapture)
    monkeypatch.setattr(Trainer, "_graphable", lambda self, generator: generator is None)
    monkeypatch.setattr(Trainer, "_step_on_capture_stream", lambda self, *a: self._step(*a))
    trainer = _din_trainer()
    state = [*trainer.prepare(trainer.init_params(seed=1)), M.init_metrics("cpu")]
    for batch in _din_batches(1) * (GRAPH_WARMUP_STEPS + 1):
        state = _run(trainer, state, batch)
    assert trainer.step_counts() == _counts(eager=GRAPH_WARMUP_STEPS, captured=1)
    refs = weakref.ref(trainer), weakref.ref(trainer._graph)
    gc.disable()
    try:
        del trainer, state
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


def test_a_two_epoch_fit_equals_its_eager_twin(monkeypatch):
    ds = synthetic_ctr_dataset(BATCH * 6 - 5, seed=4)
    trainers = [_as_card(_din_trainer(), monkeypatch), _din_trainer()]
    init = trainers[0].init_params(seed=2)
    a, b = (t.fit(ds, params=init, verbose=False) for t in trainers)
    assert a.history == b.history and _equal(a.params, b.params)
    assert _equal(a.opt_state, b.opt_state) and int(a.opt_state.count) == 12
    w = GRAPH_WARMUP_STEPS
    assert trainers[0].step_counts() == _counts(eager=w, captured=1, replayed=11 - w)


# ---- the card -----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cell(name):
    with open(os.path.join(REPO, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


def _card_twins(model_name, batch=8192, t=64, seed=5):
    """Two trainers at the cell's widths, the second always eager, and
    their states from one init; the cell's column generator."""
    from sparrowrecsys_torch.models.dien import dien_loss_fn

    cfg = _cell(f"{model_name}_sparrow")
    kw = dict(dim=cfg["dim"], hidden=cfg["hidden"], recent_movies=t,
              user_buckets=cfg["user_buckets"], movie_buckets=cfg["movie_buckets"],
              compute_dtype=cfg["compute_dtype"])
    if model_name == "din":
        kw["attention_hidden"] = cfg["attention_hidden"]
    else:
        kw.update(aux_mode=cfg["aux_mode"], alpha=cfg["alpha"])
    trainers = []
    for _ in range(2):
        loss_fn = (dien_loss_fn(alpha=cfg["alpha"], aux_mode=cfg["aux_mode"], recent_movies=t,
                                movie_vocab=cfg["movie_buckets"])
                   if model_name == "dien" else None)
        trainers.append(Trainer(build_model(cfg["model"], **kw),
                                TrainConfig(batch_size=batch, epochs=2), loss_fn=loss_fn,
                                device="cuda"))
    trainers[1]._graphable = lambda generator: False
    init = trainers[0].init_params(seed=seed)
    states = [list(tr.prepare(init)) + [M.init_metrics("cuda")] for tr in trainers]
    return cfg, trainers, states


def _card_batches(model_name, cfg, n, batch=8192, t=64, seed=7):
    from benchmark import weights, weights_dien

    make = weights.train_columns if model_name == "din" else weights_dien.train_columns
    traffic = {"history": t, "movie_zipf_s": 1.0, "label_p": 0.5}
    feats, labels = make(cfg, traffic, seed, "cuda", n * batch)
    mask = torch.ones(batch, device="cuda")
    return [({k: v[i * batch:(i + 1) * batch] for k, v in feats.items()},
             labels[i * batch:(i + 1) * batch], mask) for i in range(n)]


def _gap(a, b) -> float:
    """The largest absolute difference over two states' tensors."""
    return max(float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
               for x, y in zip(leaves(a), leaves(b)))


@pytest.mark.cuda
@pytest.mark.parametrize("model_name", ["din", "dien"])
def test_card_replayed_steps_equal_eager_ones(cuda_device, model_name):
    """12 steps cycling 4 batches at the cell's widths, a fresh metric state
    after step 6: each step's state bit for bit the eager twin's."""
    cfg, (gt, et), (gs, es) = _card_twins(model_name)
    batches = _card_batches(model_name, cfg, 4)
    for i in range(12):
        if i == 6:
            gs[2], es[2] = M.init_metrics("cuda"), M.init_metrics("cuda")
        gs = _run(gt, gs, batches[i % 4])
        es = _run(et, es, batches[i % 4])
        assert _gap(gs, es) == 0.0, f"step {i + 1}"
    w = GRAPH_WARMUP_STEPS
    assert gt.step_counts() == _counts(eager=w, captured=1, replayed=11 - w)
    assert int(gs[1].count) == 12 and _equal(gs, es)


@pytest.mark.cuda
def test_card_odd_steps_run_eagerly_and_the_graph_stays(cuda_device):
    """On the card: a profiled step and a batch of another shape run eagerly
    on the graph's state and keep the graph; a foreign state runs eagerly
    and is captured again after the warm-up; all bit for bit the eager
    twin's, and the profiled step's spans in its trace."""
    from torch.profiler import ProfilerActivity, profile

    cfg, (gt, et), (gs, es) = _card_twins("din")
    batches = _card_batches("din", cfg, 2)
    short = _card_batches("din", cfg, 1, batch=4096, seed=8)[0]
    w = GRAPH_WARMUP_STEPS
    for i in range(w + 2):
        gs, es = _run(gt, gs, batches[i % 2]), _run(et, es, batches[i % 2])
    graph = gt._graph
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gs, es = _run(gt, gs, batches[0]), _run(et, es, batches[0])
        torch.cuda.synchronize()
    assert "trainer.step" in {e.name for e in prof.events()}
    gs, es = _run(gt, gs, short), _run(et, es, short)
    gs, es = _run(gt, gs, batches[1]), _run(et, es, batches[1])
    assert gt._graph is graph and gs[1] is graph.opt_state
    assert gt.step_counts() == _counts(eager=w + 2, captured=1, replayed=2)
    assert _gap(gs, es) == 0.0
    foreign = copy.deepcopy(gs)
    for i in range(w + 2):
        foreign, es = _run(gt, foreign, batches[i % 2]), _run(et, es, batches[i % 2])
    assert gt.step_counts() == _counts(eager=2 * w + 2, captured=2, replayed=3)
    assert gt._graph is not graph and _gap(foreign, es) == 0.0


@pytest.mark.cuda
def test_card_two_epoch_fit_equals_its_eager_twin(cuda_device):
    cfg, (gt, et), _ = _card_twins("din", batch=4096)
    feats, labels, _ = zip(*_card_batches("din", cfg, 6, batch=4096))
    ds = EncodedDataset({k: torch.cat([f[k] for f in feats]) for k in feats[0]},
                        torch.cat(labels))
    init = gt.init_params(seed=3)
    a, b = gt.fit(ds, params=init, verbose=False), et.fit(ds, params=init, verbose=False)
    assert a.history == b.history and _gap(a.params, b.params) == 0.0
    assert _gap(a.opt_state, b.opt_state) == 0.0 and int(a.opt_state.count) == 12
    w = GRAPH_WARMUP_STEPS
    assert gt.step_counts() == _counts(eager=w, captured=1, replayed=11 - w)


@pytest.mark.cuda
def test_card_a_dropped_trainer_frees_its_graph(cuda_device):
    """A trainer and its graph hold no reference cycle: once the trainer and
    its state are dropped, the graph is freed at once (its memory pool with
    it), with the cycle collector off."""
    cfg, trainers, states = _card_twins("din", batch=4096)
    batches = _card_batches("din", cfg, 2, batch=4096)
    gt, gs = trainers[0], states[0]
    for i in range(GRAPH_WARMUP_STEPS + 2):
        gs = _run(gt, gs, batches[i % 2])
    graph = weakref.ref(gt._graph)
    assert graph() is not None
    gc.disable()
    try:
        del gt, gs, trainers, states
        assert graph() is None
    finally:
        gc.enable()

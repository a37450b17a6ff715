"""The port's spans (`utils/profiling.py::span`, `backward_span`) in a DIN
`Trainer._train_step` on the CPU: under a profiler the exported Chrome
trace nests the step's forward, backward and optimizer in
`trainer.step`, and each embedding lookup's backward is its own
`embedding.backward` range; a traced step computes what an untraced one
does, bit for bit; with no profiler recording the spans enter no
`record_function` and add no autograd node."""

import contextlib
import copy
import glob
import json
import os

import pytest
import torch

import sparrowrecsys_torch.utils as tutils
from sparrowrecsys_torch.config import TrainConfig
from sparrowrecsys_torch.data.synthetic import synthetic_ctr_dataset
from sparrowrecsys_torch.models import build_model
from sparrowrecsys_torch.ops import embedding as emb
from sparrowrecsys_torch.ops import metrics as M
from sparrowrecsys_torch.training import loop
from sparrowrecsys_torch.training.loop import Trainer

torch.set_num_threads(2)

BATCH = 32
PHASES = ("trainer.forward", "trainer.backward", "trainer.optimizer")
#: DIN's lookups: the movie table (candidate and history), the user, and
#: the two genre columns.
DIN_LOOKUPS = 4


@pytest.fixture(scope="module")
def din():
    """(trainer, (params, opt_state, mstate) after one warm step, batch)."""
    ds = synthetic_ctr_dataset(BATCH, seed=3)
    model = build_model("din", dim=4, attention_hidden=8, hidden=16)
    trainer = Trainer(model, TrainConfig(batch_size=BATCH, epochs=1), device="cpu")
    params, opt_state = trainer.prepare(trainer.init_params(seed=1))
    batch = ({k: torch.as_tensor(v) for k, v in ds.features.items()},
             torch.as_tensor(ds.labels), torch.ones(BATCH))
    state = trainer._train_step(params, opt_state, M.init_metrics("cpu"), *batch)
    return trainer, state, batch


def _step(din):
    """One step from a copy of the fixture's state; the new state."""
    trainer, state, batch = din
    return trainer._train_step(*copy.deepcopy(state), *batch)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _events(log_dir):
    """The complete events of the one Chrome trace `trace()` wrote."""
    (path,) = glob.glob(os.path.join(str(log_dir), "*.pt.trace.json"))
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _ranges(events, name):
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
            if e["name"] == name]


def test_step_spans_nest_in_the_trace(din, tmp_path):
    with tutils.trace(str(tmp_path)):
        _step(din)
    events = _events(tmp_path)
    (step,) = _ranges(events, "trainer.step")
    phases = [_ranges(events, name) for name in PHASES]
    assert all(len(r) == 1 for r in phases)
    (fwd,), (bwd,), (opt,) = phases
    assert step[0] <= fwd[0] and fwd[1] <= bwd[0] and bwd[1] <= opt[0] and opt[1] <= step[1]
    lookups = _ranges(events, "embedding.backward")
    assert len(lookups) == DIN_LOOKUPS
    assert all(bwd[0] <= s and e <= bwd[1] for s, e in lookups)

    def within(name):
        return [e for e in events if name in e["name"]
                and any(s <= float(e["ts"]) <= t for s, t in lookups)]

    assert len(within("aten::embedding_dense_backward")) == DIN_LOOKUPS
    assert not within("_DINAttentionBackward")
    assert _ranges(events, "autograd::engine::evaluate_function: _DINAttentionBackward")


def test_traced_step_computes_what_an_untraced_one_does(din, tmp_path):
    plain = _step(din)
    with tutils.trace(str(tmp_path)):
        traced = _step(din)
    a, b = _leaves(plain), _leaves(traced)
    assert len(a) == len(b) > 0
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_profiler_off_enters_no_record_function(din, tmp_path, monkeypatch):
    entered = []
    real = torch.autograd.profiler.record_function.__enter__

    def count(self):
        entered.append(self.name)
        return real(self)

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", count)
    _step(din)
    assert entered == []
    with tutils.trace(str(tmp_path)):
        _step(din)
    spans = {"trainer.step", *PHASES, "embedding.backward"}
    assert spans <= set(entered)
    assert entered.count("embedding.backward") == DIN_LOOKUPS


def _graph_nodes(din, monkeypatch) -> int:
    """The number of autograd nodes in the loss's graph of one step."""
    trainer = din[0]
    losses = []
    real = trainer._loss

    def keep(*a, **k):
        out = real(*a, **k)
        losses.append(out[0])
        return out

    monkeypatch.setattr(trainer, "_loss", keep)
    _step(din)
    monkeypatch.setattr(trainer, "_loss", real)
    seen, todo = set(), [losses[0].grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(n for n, _ in node.next_functions)
    return len(seen)


def test_profiler_off_adds_no_autograd_node(din, tmp_path, monkeypatch):
    with_spans = _graph_nodes(din, monkeypatch)
    with monkeypatch.context() as m:
        m.setattr(emb, "backward_span", lambda name, fn, *a, **k: fn(*a, **k))
        m.setattr(loop, "span", lambda name: contextlib.nullcontext())
        without = _graph_nodes(din, m)
    assert with_spans == without
    with tutils.trace(str(tmp_path)):
        traced = _graph_nodes(din, monkeypatch)
    # one identity on each lookup's output and one on its table
    assert traced == without + 2 * DIN_LOOKUPS


class _OneRankPlan:
    """The part of a mesh plan that `sharded_lookup` reads, for one model
    rank holding every row."""

    n_model, model_index, model_axis = 1, 0, "model"

    @staticmethod
    def all_reduce(x, axis):
        return x


@pytest.mark.parametrize("sharded", [False, True])
def test_lookup_backward_is_a_span_on_either_path(tmp_path, sharded):
    table = torch.randn(11, 3, requires_grad=True)
    ids = torch.tensor([[0, 3, 10], [4, 4, 12]])
    shards = {table: emb.RowShard(_OneRankPlan(), 11)} if sharded else {}
    with tutils.trace(str(tmp_path)):
        with emb.row_sharded(shards):
            out = emb.embed_lookup(table, ids, mask_zero=True)
        (grad,) = torch.autograd.grad(out.sum(), [table])
    events = _events(tmp_path)
    ((s, t),) = _ranges(events, "embedding.backward")
    assert any(e["name"] == "aten::embedding_dense_backward" and s <= float(e["ts"]) <= t
               for e in events)
    # rows 3 and 4 (twice) were looked up; pad id 0 and id 12 give zeros
    want = torch.zeros(11, 3)
    want[3], want[4], want[10] = 1.0, 2.0, 1.0
    assert torch.equal(grad, want)


DLRM_SPANS = ("dlrm.bottom", "dlrm.lookups", "dlrm.cross", "dlrm.top")


@pytest.fixture(scope="module")
def dlrm():
    """A tiny DLRM trainer with one table on the lazy row-Adam: (trainer,
    (params, opt_state, mstate) after one warm step, batch)."""
    torch.manual_seed(5)
    model = build_model("dlrm_dcnv2", embedding_dim=4, dense_sizes=(8, 4),
                        over_sizes=(8, 1), cross_layers=2, cross_rank=3,
                        table_rows=(5000, 7, 30), multi_hot=(2, 1, 3))
    trainer = Trainer(model, TrainConfig(batch_size=BATCH, epochs=1), device="cpu",
                      sparse_tables=model.sparse_tables())
    assert tuple(trainer.sparse_tables) == ("emb_cat_0",)
    params, opt_state = trainer.prepare({k: v.detach().clone()
                                         for k, v in model.state_dict().items()})
    g = torch.Generator().manual_seed(2)
    feats = {"dense": torch.randn(BATCH, 13, generator=g)}
    for f, (rows, k) in enumerate(zip(model.table_rows, model.multi_hot)):
        feats[f"cat_{f}"] = torch.randint(0, rows, (BATCH, k), generator=g, dtype=torch.int32)
    batch = (feats, (torch.rand(BATCH, generator=g) < 0.5).float(), torch.ones(BATCH))
    state = trainer._train_step(params, opt_state, M.init_metrics("cpu"), *batch)
    return trainer, state, batch


def test_dlrm_and_row_adam_spans_under_a_profiler_and_free_without(dlrm, tmp_path,
                                                                     monkeypatch):
    """Under a recording profiler the model's four forward spans nest in
    `trainer.forward`, the cross layers' backward in `trainer.backward`, and
    the row-Adam in `trainer.optimizer`; with none recording, no span
    enters a `record_function`, and the spans add no autograd node."""
    from sparrowrecsys_torch.models import dlrm as dlrm_model

    with tutils.trace(str(tmp_path)):
        _step(dlrm)
    events = _events(tmp_path)
    (fwd,), (bwd,), (opt,) = [_ranges(events, name) for name in PHASES]
    for name in DLRM_SPANS:
        ((s, t),) = _ranges(events, name)
        assert fwd[0] <= s and t <= fwd[1], name
    ((s, t),) = _ranges(events, "dlrm.cross.backward")
    assert bwd[0] <= s and t <= bwd[1]
    ((s, t),) = _ranges(events, "trainer.row_adam")
    assert opt[0] <= s and t <= opt[1]
    assert len(_ranges(events, "embedding.backward")) == 3

    entered = []
    real = torch.autograd.profiler.record_function.__enter__

    def count(self):
        entered.append(self.name)
        return real(self)

    with monkeypatch.context() as m:
        m.setattr(torch.autograd.profiler.record_function, "__enter__", count)
        _step(dlrm)
    assert entered == []
    with_spans = _graph_nodes(dlrm, monkeypatch)
    with monkeypatch.context() as m:
        m.setattr(dlrm_model, "span", lambda name: contextlib.nullcontext())
        m.setattr(dlrm_model, "backward_span", lambda name, fn, *a, **k: fn(*a, **k))
        m.setattr(emb, "backward_span", lambda name, fn, *a, **k: fn(*a, **k))
        assert _graph_nodes(dlrm, m) == with_spans

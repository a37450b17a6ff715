"""The port's DLRM-DCNv2 (`models/dlrm.py`) against the plain reference
(`reference/dlrm_dcnv2.py`) on the CPU, at tiny sizes.

D = 8, four tables: two of more than 2,048 rows (outside `bwd_fits` at
D = 8, so a trainer puts them in `sparse_tables` and trains them with the
lazy row-Adam), two small ones (the small-table backward and the dense
Adam); two features multi-hot; batch 16. Tolerances, float32 on both
sides, the same arithmetic grouped differently (the program's cross layer
is one `addmm`, its lookups one gather and a sum, its Adam a fused
multiply-add):
- logits and the loss: 1e-5 of their scale;
- gradients: 1e-4 of each one's scale (sums of 16 rows in another order);
- parameters and Adam's moments after 3 steps: 1e-6 absolute on the
  parameters (a thousandth of Adam's step of 1e-3) and 1e-5 of each
  moment's scale, except where a gradient element is at the round-off of
  its leaf (1e-5 of the leaf's largest), whose sign Adam turns into a
  whole step either way.
The JAX package has no DLRM.
"""

import filecmp
import os

import pytest
import torch

from reference import dlrm_dcnv2 as ref
from sparrowrecsys_torch.config import TrainConfig
from sparrowrecsys_torch.models import build_model
from sparrowrecsys_torch.models.dlrm import MULTI_HOT, TABLE_ROWS
from sparrowrecsys_torch.ops import embedding as emb
from sparrowrecsys_torch.ops import metrics as M
from sparrowrecsys_torch.training import loop, row_optim
from sparrowrecsys_torch.training.loop import Trainer
from sparrowrecsys_torch.training.optim import split_leaves

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, D = 16, 8
ROWS = (3000, 5, 2500, 40)
HOT = (3, 1, 1, 4)
SPARSE = ("emb_cat_0", "emb_cat_2")
OPT = {"learning_rate": 1e-3, "adam_b1": 0.9, "adam_b2": 0.999, "adam_eps": 1e-7}
BASE = {"embedding_dim": D, "dense_sizes": (16, D), "over_sizes": (32, 16, 1),
        "cross_layers": 3, "cross_rank": 4, "table_rows": ROWS, "multi_hot": HOT}
#: The layer options the parametrised comparisons run over.
OPTIONS = {
    "published_depths": {},
    "one_wide_cross": {"cross_layers": 1, "cross_rank": 64},
    "no_cross": {"cross_layers": 0},
    "one_layer_arches": {"dense_sizes": (D,), "over_sizes": (1,)},
}


def _close(got, want, rel, what):
    got, want = got.detach().double(), want.detach().double()
    scale = max(float(want.abs().max()), 1e-12)
    err = float((got - want).abs().max())
    assert err <= rel * scale, f"{what}: max error {err} against {rel} of {scale}"


def _model(seed=7, **kw):
    torch.manual_seed(seed)
    return build_model("dlrm_dcnv2", **{**BASE, **kw})


def _weights(model):
    """The model's own initial weights, with every bias made non-zero."""
    g = torch.Generator().manual_seed(11)
    w = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for k in w:
        if k.endswith(".b") or k.endswith(".bias"):
            w[k] = 0.05 * torch.randn(w[k].shape, generator=g)
    return w


def _batches(seed, n=3, rows=ROWS, hot=HOT):
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        feats = {"dense": torch.randn(B, 13, generator=g)}
        for f, (r, k) in enumerate(zip(rows, hot)):
            # A skewed draw over a few rows, so rows repeat within a batch.
            feats[f"cat_{f}"] = torch.randint(0, min(r, 20), (B, k), generator=g,
                                              dtype=torch.int32)
        out.append((feats, (torch.rand(B, generator=g) < 0.5).float()))
    return out


def test_registry_builds_the_published_model_on_the_meta_device():
    with torch.device("meta"):
        model = build_model("dlrm_dcnv2")
    assert all(p.is_meta for p in model.parameters())
    assert sum(MULTI_HOT) == 214 and len(TABLE_ROWS) == 26
    shapes = ref.param_shapes(128, (512, 256, 128), (1024, 1024, 512, 256, 1), 3, 512,
                              TABLE_ROWS)
    assert {k: tuple(p.shape) for k, p in model.named_parameters()} == shapes
    assert shapes["cross.0.v"] == (3456, 512) and shapes["top.0.weight"] == (1024, 3456)
    sparse = model.sparse_tables()
    assert len(sparse) == 19 and sparse["emb_cat_0"] == ("cat_0",)
    small = [f for f, rows in enumerate(TABLE_ROWS) if f"emb_cat_{f}" not in sparse]
    assert [TABLE_ROWS[f] for f in small] == [3, 63, 10, 4, 14, 108, 36]


def test_widths_are_checked():
    with pytest.raises(ValueError, match="multi-hot"):
        build_model("dlrm_dcnv2", table_rows=(3, 4), multi_hot=(1,))
    with pytest.raises(ValueError, match="width"):
        build_model("dlrm_dcnv2", **{**BASE, "dense_sizes": (16, 4)})


@pytest.mark.parametrize("opts", list(OPTIONS.values()), ids=list(OPTIONS))
def test_logits_loss_and_gradients_match_the_reference(opts):
    model = _model(**opts)
    w = _weights(model)
    feats, labels = _batches(3)[0]
    model.load_state_dict(w)
    leaves = {k: v.clone().requires_grad_() for k, v in w.items()}
    logits = torch.func.functional_call(model, leaves, (feats,))
    _close(logits, ref.forward(w, feats), 1e-5, "logits")
    loss = torch.nn.functional.binary_cross_entropy_with_logits(logits, labels)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    want_loss, want = ref.loss_and_grads(w, feats, labels, block=5)
    assert abs(float(loss.detach()) - want_loss) <= 1e-5 * abs(want_loss)
    assert set(grads) == set(want)
    for k in want:
        _close(grads[k], want[k], 1e-4, k)


def _trainer(model, sparse=True):
    return Trainer(model, TrainConfig(batch_size=B, epochs=1, adam_eps=OPT["adam_eps"]),
                   device="cpu", sparse_tables=model.sparse_tables() if sparse else None)


@pytest.mark.parametrize("meta", [False, True], ids=["built", "meta"])
def test_three_train_steps_match_the_reference(meta):
    """`Trainer._train_step` (lazy row-Adam on the two large tables, the
    grouped Adam on the rest) against the reference's three steps: the
    parameters and both moments. A model built on the meta device trains
    the same."""
    built = _model()
    w0 = _weights(built)
    if meta:
        with torch.device("meta"):
            built = _model()
    trainer = _trainer(built)
    assert tuple(trainer.sparse_tables) == SPARSE
    assert all(p.is_meta for p in trainer.model.parameters()) == meta
    params, opt_state = trainer.prepare(w0)
    mstate = M.init_metrics("cpu")
    batches = _batches(5)
    for f, y in batches:
        params, opt_state, mstate = trainer._train_step(params, opt_state, mstate, f, y,
                                                        torch.ones(B))
    w = {k: v.clone() for k, v in w0.items()}
    sparse = [f"{m}.table" for m in SPARSE]
    adam = ref.Adam(w, OPT["learning_rate"], OPT["adam_b1"], OPT["adam_b2"], OPT["adam_eps"],
                    sparse)
    noisy = {}
    for f, y in batches:
        _, g = ref.loss_and_grads(w, f, y)
        for k, v in g.items():
            noisy[k] = noisy.get(k, torch.zeros_like(v, dtype=torch.bool)) | (
                v.abs() <= 1e-5 * v.abs().max())
        adam.step(w, g, {k: ref.touched_rows(w[k], f[k[4:-6]]) for k in sparse})

    got = trainer.whole_params(params, opt_state)
    mu, nu = {}, {}
    dense = opt_state["dense"]
    small, big = split_leaves(params, trainer.tx.small_max_elems)
    for k, a, b in zip(small, dense.mu_vec.split([params[k].numel() for k in small]),
                       dense.nu_vec.split([params[k].numel() for k in small])):
        mu[k], nu[k] = a.view(params[k].shape), b.view(params[k].shape)
    for k, a, b in zip(big, dense.mu_big, dense.nu_big):
        mu[k], nu[k] = a, b
    for m in SPARSE:  # in place of the dense state's empty placeholders
        buf = opt_state["rows"][m].buf
        mu[f"{m}.table"], nu[f"{m}.table"] = buf[:, D:2 * D], buf[:, 2 * D:]
    for k in w0:
        err = (got[k] - w[k]).abs().masked_fill(noisy[k], 0.0)
        assert float(err.max()) <= 1e-6, (k, float(err.max()))
        _close(mu[k], adam.mu[k], 1e-5, f"{k} mu")
        _close(nu[k], adam.nu[k], 1e-5, f"{k} nu")
    # Lazy: a row no step touched kept its value and its zero moments.
    untouched = torch.ones(ROWS[0], dtype=torch.bool)
    for f, _ in batches:
        untouched[f["cat_0"].long().reshape(-1)] = False
    assert torch.equal(got["emb_cat_0.table"][untouched], w0["emb_cat_0.table"][untouched])
    assert not mu["emb_cat_0.table"][untouched].any()


def test_large_tables_take_the_row_adam_and_small_ones_the_kernels_twin(monkeypatch):
    """With the CPU let onto the kernel's path: the two tables outside
    `bwd_fits` train through `fused_row_adam_update_many` and autograd's dense
    backward, the two inside through `embedding_bwd` (its twin on the CPU)
    and the grouped Adam."""
    monkeypatch.setattr(emb, "_KERNEL_DEVICES", ("cuda", "cpu"))
    bwd, rows = [], []
    real_bwd, real_rows = emb.embedding_bwd, row_optim.fused_row_adam_update_many

    def count_bwd(g, ids, v, lo):
        bwd.append(v)
        return real_bwd(g, ids, v, lo)

    def count_rows(states, grads, ids, **kw):
        rows.extend(st.buf.shape[0] for st in states)
        return real_rows(states, grads, ids, **kw)

    monkeypatch.setattr(emb, "embedding_bwd", count_bwd)
    monkeypatch.setattr(loop, "fused_row_adam_update_many", count_rows)
    model = _model()
    trainer = _trainer(model)
    params, opt_state = trainer.prepare(_weights(model))
    assert set(opt_state["rows"]) == set(SPARSE)
    assert params["emb_cat_0.table"].numel() == 0 and params["emb_cat_1.table"].shape == (5, D)
    f, y = _batches(9)[0]
    trainer._train_step(params, opt_state, M.init_metrics("cpu"), f, y, torch.ones(B))
    assert sorted(bwd) == [5, 40] and sorted(rows) == [2500, 3000]


def _row_states(device, widths=(8, 8, 3, 8), rows=(50, 7, 20, 3000)):
    g = torch.Generator().manual_seed(13)
    states, grads, ids = [], [], []
    for v, d in zip(rows, widths):
        st = row_optim.init_fused_row_adam(torch.randn(v, d, generator=g).to(device))
        states.append(row_optim.FusedRowAdamState(st.count, st.buf))
        grads.append(torch.randn(v, d, generator=g).to(device))
        # repeats, and ids out of the table on both sides
        ids.append(torch.randint(-2, v + 2, (40,), generator=g, dtype=torch.int32).to(device))
    return states, grads, ids


def _step_each_and_many(device):
    kw = dict(learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-7)
    alone, grads, ids = _row_states(device)
    many = [row_optim.FusedRowAdamState(st.count, st.buf.clone()) for st in alone]
    for _ in range(3):
        alone = [row_optim.fused_row_adam_update(st, g, i, **kw)
                 for st, g, i in zip(alone, grads, ids)]
        many = row_optim.fused_row_adam_update_many(many, grads, ids, **kw)
    return alone, many


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_many_tables_step_as_each_would_alone(device):
    """`fused_row_adam_update_many` over tables of two widths, with
    repeated and out-of-range ids, three steps: each buffer bit for bit as
    `fused_row_adam_update` leaves it stepping that table alone, and one
    shared count. On the card through the row kernels, each gather into a
    slice of one block (`rows_gather(out=)`)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the row kernels have no CPU mode")
    alone, many = _step_each_and_many(device)
    for a, m in zip(alone, many):
        assert torch.equal(a.buf, m.buf)
        assert int(m.count) == 3 and m.count is many[0].count
    assert not torch.equal(many[3].buf, _row_states(device)[0][3].buf)


def test_bfloat16_compute_stays_near_float32():
    model = _model()
    w = _weights(model)
    feats, _ = _batches(4)[0]
    narrow = _model(compute_dtype="bfloat16")
    with torch.no_grad():
        wide = torch.func.functional_call(model, w, (feats,))
        got = torch.func.functional_call(narrow, w, (feats,))
    assert got.dtype == torch.float32
    _close(got, wide, 3e-2, "bfloat16 logits")
    assert not torch.equal(got, wide)


def test_lower_precision_rounds_every_product_to_tf32():
    model = _model()
    w = _weights(model)
    feats, _ = _batches(6)[0]
    x = torch.tensor([1.0 + 2 ** -12, 3.0 + 2 ** -20])
    assert torch.equal(ref._lowered(x), torch.tensor([1.0, 3.0]))
    with torch.no_grad():
        stated, lowered = ref.forward(w, feats), ref.forward(w, feats, "lower")
    gap = float((stated - lowered).abs().max() / stated.abs().max())
    assert 1e-6 < gap < 1e-2


def test_the_frozen_copy_is_the_reference():
    assert filecmp.cmp(os.path.join(REPO, "reference", "dlrm_dcnv2.py"),
                       os.path.join(REPO, "benchmark", "reference", "dlrm_dcnv2.py"),
                       shallow=False)

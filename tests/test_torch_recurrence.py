"""DIEN's recurrences on the kernels' path (`ops/augru.py`,
`csrc/recurrence.cu`).

On the CPU: each kernel's plain twin, through the autograd Functions the
card runs (`_GRUKernel`, `_AUGRUKernel`, whose wrappers take the twins
for CPU tensors), against the autograd loop of the plain path at T = 1,
5 and 64 with masked steps; the plain loop's gradients against the
per-step slices it took before; the path's choice by device, dtype and
width; the four DIEN spans under a profiler. On the card (`cuda` marker):
each kernel against its twin at H = 10 and 32, odd batches, all-masked
rows, two calls bit-equal, one launch a call, and DIEN's training step
launching each kernel once a step.

Tolerances (float32): outputs 1e-5 of their scale, gradients 1e-4 of
each one's scale; the twins sum each product one term at a time where
the loop's products sum in BLAS's order, and the weight gradients are
one product over the stacked steps where the loop adds them step by
step. This file imports no JAX, so the card's machine runs it:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_recurrence.py
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from sparrowrecsys_torch.ops import augru as A
from sparrowrecsys_torch.ops import kernels

torch.set_num_threads(2)

OUT_TOL, GRAD_TOL = 1e-5, 1e-4


def _close(got, ref, rel, what):
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
    scale = max(float(ref.abs().max()), 1e-6)
    err = float((got - ref).abs().max())
    assert err <= rel * scale, f"{what}: max error {err} against {rel} of {scale}"


def _inputs(b, t, h, seed=0, device="cpu"):
    """gx [B, T, 3H], mask [B, T] (a row with no live step, a masked first
    step, a masked last step, about a fifth masked), the GRU's recurrent
    weight, the AUGRU's, an attention a step, output gradients."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=0.5: torch.from_numpy((rng.normal(size=s) * sc).astype(np.float32))  # noqa: E731
    mask = rng.random((b, t)) < 0.8
    mask[0] = False
    if b > 1:
        mask[1, 0] = False
    if b > 2:
        mask[2, -1] = False
    out = dict(gx=f(b, t, 3 * h, sc=1.0), mask=torch.from_numpy(mask), u=f(h, 3 * h),
               u_rz=f(h, 2 * h), u_h=f(h, h),
               att=torch.from_numpy(rng.random((b, t)).astype(np.float32)),
               g_hs=f(b, t, h, sc=1.0), g_fin=f(b, h, sc=1.0))
    return {k: v.to(device) for k, v in out.items()}


def _grads(out, g, *xs):
    return torch.autograd.grad((out * g).sum(), xs)


def _gru_both(a):
    """(the Function's hs and grads, the plain loop's), for gx and U."""
    got = []
    for path in ("kernel", "loop"):
        gx, u = a["gx"].clone().requires_grad_(), a["u"].clone().requires_grad_()
        if path == "kernel":
            hs = A._GRUKernel.apply(u, gx, a["mask"])
        else:
            hs = A._gru_scan(u, gx.transpose(0, 1), a["mask"].transpose(0, 1),
                             gx.new_zeros(gx.shape[0], u.shape[0])).transpose(0, 1)
        got.append((hs, _grads(hs, a["g_hs"], gx, u)))
    return got


def _augru_both(a):
    got = []
    h = a["u_h"].shape[0]
    for path in ("kernel", "loop"):
        x = a["gx"].clone().requires_grad_()
        u_rz, u_h = a["u_rz"].clone().requires_grad_(), a["u_h"].clone().requires_grad_()
        att = a["att"].clone().requires_grad_()
        if path == "kernel":
            hf = A._AUGRUKernel.apply(u_rz, u_h, x, att)
        else:
            b, t = att.shape
            hf = A._augru_scan(u_rz, u_h, x.transpose(0, 1),
                               att[..., None].expand(b, t, h).transpose(0, 1), x.new_zeros(b, h))
        got.append((hf, _grads(hf, a["g_fin"], x, u_rz, u_h, att)))
    return got


@pytest.mark.parametrize("t", [1, 5, 64])
@pytest.mark.parametrize("h", [3, 10])
def test_gru_twins_match_the_autograd_loop(t, h):
    (hs, grads), (ref, ref_grads) = _gru_both(_inputs(9, t, h, seed=t + h))
    _close(hs, ref, OUT_TOL, "hs")
    for name, g, r in zip(("gx", "recurrent"), grads, ref_grads):
        _close(g, r, GRAD_TOL, name)


@pytest.mark.parametrize("t", [1, 5, 64])
@pytest.mark.parametrize("h", [3, 10])
def test_augru_twins_match_the_autograd_loop(t, h):
    (hf, grads), (ref, ref_grads) = _augru_both(_inputs(9, t, h, seed=2 * t + h))
    _close(hf, ref, OUT_TOL, "h_final")
    for name, g, r in zip(("x_all", "u_rz", "u_h", "att"), grads, ref_grads):
        _close(g, r, GRAD_TOL, name)


def test_twins_masked_rows_carry_zero_state_and_pass_gradients_through():
    """A row with no live step keeps h = 0, its pre-activation gradients
    are zero, and its output gradients sum into dh0 unchanged."""
    a = _inputs(4, 6, 5, seed=1)
    hs = A.gru_scan_fwd_plain(a["u"], a["gx"], a["mask"])
    assert torch.equal(hs[0], torch.zeros_like(hs[0]))
    dgx, ops, dh0 = A.gru_scan_bwd_plain(a["u"], a["gx"], a["mask"], hs, a["g_hs"])
    assert torch.equal(dgx[0], torch.zeros_like(dgx[0]))
    _close(dh0[0], a["g_hs"][0].sum(0), 1e-6, "dh0 of an all-masked row")
    assert ops.shape == (4, 6, 10) and dgx.shape == (4, 6, 15)


def _sliced_gru(recurrent, gx, mask, h0):
    """The plain loop as it was: a slice gx[t] a step."""
    h, hs = h0, []
    for t in range(gx.shape[0]):
        h = A._gru_step(recurrent, h, gx[t], mask[t])[0]
        hs.append(h)
    return torch.stack(hs)


def _sliced_augru(u_rz, u_h, x_all, att, h0):
    h = h0
    for t in range(x_all.shape[0]):
        h = A._augru_step(u_rz, u_h, h, x_all[t], att[t])[0]
    return h


def test_plain_loop_gradients_are_the_sliced_loops():
    """`unbind` in place of a slice a step: the same gradients, bit for bit
    (each slice's gradient was the step's, zero-padded, and the pads add
    exact zeros), and one autograd node on the stacked input, not T."""
    a = _inputs(7, 12, 4, seed=5)
    gx_tm, m_tm = a["gx"].transpose(0, 1).contiguous(), a["mask"].transpose(0, 1)
    h0 = torch.zeros(7, 4)
    got = []
    for fn in (A._gru_scan, _sliced_gru):
        gx, u = gx_tm.clone().requires_grad_(), a["u"].clone().requires_grad_()
        hs = fn(u, gx, m_tm, h0)
        got.append(_grads(hs, a["g_hs"].transpose(0, 1), gx, u))
        if fn is A._gru_scan:
            names = _walk(hs.grad_fn)
            assert "UnbindBackward0" in names and "SelectBackward0" not in names
    for g, r in zip(*got):
        assert torch.equal(g, r)
    att = a["att"].transpose(0, 1)[..., None].expand(12, 7, 4)
    got = []
    for fn in (A._augru_scan, _sliced_augru):
        x = gx_tm.clone().requires_grad_()
        u_rz, u_h = a["u"][:, :8].clone().requires_grad_(), a["u_h"].clone().requires_grad_()
        hf = fn(u_rz, u_h, x, att, h0)
        got.append(_grads(hf, a["g_fin"][:, :4], x, u_rz, u_h))
    for g, r in zip(*got):
        assert torch.equal(g, r)


def _walk(fn, seen=None):
    """The names of the autograd graph's nodes below fn."""
    seen = set() if seen is None else seen
    if fn is None or fn in seen:
        return set()
    seen.add(fn)
    names = {type(fn).__name__}
    for nxt, _ in fn.next_functions:
        names |= _walk(nxt, seen)
    return names


@pytest.fixture
def cpu_takes_kernel(monkeypatch):
    """The kernels' path chosen on the CPU, where the wrappers take the
    twins."""
    monkeypatch.setattr(A, "_KERNEL_DEVICES", ("cuda", "cpu"))


@pytest.mark.parametrize("h,dtype,takes", [(10, torch.float32, True), (1, torch.float32, True),
                                           (32, torch.float32, True), (33, torch.float32, False),
                                           (10, torch.float64, False)])
def test_path_by_device_dtype_and_width(cpu_takes_kernel, h, dtype, takes):
    a = _inputs(3, 4, h, seed=h)
    gx, u = a["gx"].to(dtype).requires_grad_(), a["u"].to(dtype).requires_grad_()
    assert A.takes_kernel(gx, u) is takes
    hs = A.gru_recurrence(u, gx, a["mask"])
    assert (type(hs.grad_fn).__name__ == "_GRUKernelBackward") is takes
    hf = A.augru_recurrence(a["u_rz"].to(dtype), a["u_h"].to(dtype), gx, a["att"][..., None])
    assert (type(hf.grad_fn).__name__ == "_AUGRUKernelBackward") is takes


def test_cpu_tensors_keep_the_plain_loop():
    a = _inputs(3, 4, 10)
    gx, u = a["gx"].requires_grad_(), a["u"].requires_grad_()
    assert not A.takes_kernel(gx, u)
    assert type(A.gru_recurrence(u, gx, a["mask"]).grad_fn).__name__ != "_GRUKernelBackward"


def test_attention_that_differs_over_h_keeps_the_plain_loop(cpu_takes_kernel):
    """One scalar a step ([B, T, 1], or it expanded over H) takes the
    kernel; an attention that differs over H cannot."""
    a = _inputs(3, 4, 10)
    x = a["gx"].requires_grad_()
    per_step = a["att"][..., None].requires_grad_()
    for att, takes in ((per_step, True), (per_step.expand(3, 4, 10), True),
                       (torch.rand(3, 4, 10), False)):
        hf = A.augru_recurrence(a["u_rz"], a["u_h"], x, att)
        assert (type(hf.grad_fn).__name__ == "_AUGRUKernelBackward") is takes


def test_dien_on_the_kernels_path_gives_the_plain_paths_gradients(cpu_takes_kernel, monkeypatch):
    """A small DIEN step on the kernels' path (twins on the CPU) against
    the same step on the plain loop: the loss and every gradient."""
    from sparrowrecsys_torch.models.dien import DIEN, dien_loss_fn
    from sparrowrecsys_torch.models.features import flax_init

    t = 6
    model = DIEN(dim=10, movie_buckets=50, user_buckets=40, hidden=16, recent_movies=t)
    params = flax_init(model, torch.Generator().manual_seed(3))
    feats, labels = _dien_batch(16, t, 50, 40)
    loss_fn = dien_loss_fn(recent_movies=t, movie_vocab=50)
    got = []
    for devices in (("cuda", "cpu"), ("cuda",)):
        monkeypatch.setattr(A, "_KERNEL_DEVICES", devices)
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss, _ = loss_fn(lambda p, f: torch.func.functional_call(model, p, (f,)), leaves, feats,
                          labels, torch.ones(16))
        got.append((loss, torch.autograd.grad(loss, list(leaves.values()))))
    _close(got[0][0], got[1][0], OUT_TOL, "loss")
    for name, g, r in zip(params, got[0][1], got[1][1]):
        _close(g, r, GRAD_TOL, name)


def _dien_batch(b, t, vm, vu, seed=0):
    g = torch.Generator().manual_seed(seed)
    feats = {"movieId": torch.randint(1, vm, (b,), generator=g),
             "userId": torch.randint(0, vu, (b,), generator=g)}
    for k in range(1, t + 1):
        ids = torch.randint(0, vm, (b,), generator=g)
        ids[: b // 4] = 0 if k > t // 2 else ids[: b // 4]   # short histories
        feats[f"userRatedMovie{k}"] = ids
    for k in range(2, t + 1):
        feats[f"negativeUserRatedMovie{k}"] = torch.randint(0, vm, (b,), generator=g)
    for c in ("userGenre1", "movieGenre1"):
        feats[c] = torch.randint(-1, 19, (b,), generator=g)
    for c in ("userRatingCount", "userAvgRating", "userRatingStddev", "releaseYear",
              "movieRatingCount", "movieAvgRating", "movieRatingStddev"):
        feats[c] = torch.randn(b, generator=g)
    return feats, (torch.rand(b, generator=g) < 0.5).float()


SPANS = ("dien.gru", "dien.augru", "dien.gru.backward", "dien.augru.backward")


def test_dien_spans_under_a_profiler(tmp_path):
    """A DIEN step under `utils.trace()` exports the four recurrence spans,
    each forward span once and each backward span once, the backward ones
    after the forward ones; with no profiler the model adds no range."""
    import sparrowrecsys_torch.utils as tutils
    from sparrowrecsys_torch.models.dien import DIEN, dien_loss_fn
    from sparrowrecsys_torch.models.features import flax_init

    t = 5
    model = DIEN(dim=4, movie_buckets=30, user_buckets=20, hidden=8, recent_movies=t)
    leaves = {k: v.requires_grad_() for k, v in
              flax_init(model, torch.Generator().manual_seed(1)).items()}
    feats, labels = _dien_batch(8, t, 30, 20)
    loss_fn = dien_loss_fn(recent_movies=t, movie_vocab=30)

    def step():
        loss, _ = loss_fn(lambda p, f: torch.func.functional_call(model, p, (f,)), leaves, feats,
                          labels, torch.ones(8))
        return torch.autograd.grad(loss, list(leaves.values()))

    with tutils.trace(str(tmp_path)):
        traced = step()
    (path,) = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    at = {name: [float(e["ts"]) for e in events if e["name"] == name] for name in SPANS}
    assert all(len(v) == 1 for v in at.values()), at
    assert at["dien.gru"][0] < at["dien.augru"][0] < at["dien.augru.backward"][0] \
        < at["dien.gru.backward"][0]
    for g, r in zip(traced, step()):
        assert torch.equal(g, r)


# ---- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ran(before):
    """The kernels launched since the `kernels.launch_counts()` snapshot
    `before`, by name, with their launches."""
    return {k: n - before[k] for k, n in kernels.launch_counts().items() if n != before[k]}


CARD_SHAPES = [(333, 7, 10), (1000, 64, 10), (65, 5, 32), (129, 3, 7), (31, 64, 1), (2, 1, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h", CARD_SHAPES)
def test_gru_kernels_match_their_twins(cuda_device, b, t, h):
    a = _inputs(b, t, h, seed=b + t, device=cuda_device)
    before = kernels.launch_counts()
    hs = A.gru_scan_fwd(a["u"], a["gx"], a["mask"])
    bwd = A.gru_scan_bwd(a["u"], a["gx"], a["mask"], hs, a["g_hs"])
    assert _ran(before) == {"gru_scan_fwd": 1, "gru_scan_bwd": 1}
    twin = A.gru_scan_fwd_plain(a["u"], a["gx"], a["mask"])
    _close(hs, twin, OUT_TOL, "hs")
    assert torch.equal(hs[0], torch.zeros_like(hs[0]))          # no live step
    for name, g, r in zip(("dgx", "ops", "dh0"), bwd,
                          A.gru_scan_bwd_plain(a["u"], a["gx"], a["mask"], twin, a["g_hs"])):
        _close(g, r, GRAD_TOL, name)
    again = A.gru_scan_fwd(a["u"], a["gx"], a["mask"])
    assert torch.equal(hs, again)
    for g, r in zip(bwd, A.gru_scan_bwd(a["u"], a["gx"], a["mask"], hs, a["g_hs"])):
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h", CARD_SHAPES)
def test_augru_kernels_match_their_twins(cuda_device, b, t, h):
    a = _inputs(b, t, h, seed=b * t, device=cuda_device)
    x = a["gx"]
    before = kernels.launch_counts()
    hf, hs = A.augru_scan_fwd(a["u_rz"], a["u_h"], x, a["att"])
    bwd = A.augru_scan_bwd(a["u_rz"], a["u_h"], x, a["att"], hs, a["g_fin"])
    assert _ran(before) == {"augru_scan_fwd": 1, "augru_scan_bwd": 1}
    twin_hf, twin_hs = A.augru_scan_fwd_plain(a["u_rz"], a["u_h"], x, a["att"])
    _close(hf, twin_hf, OUT_TOL, "h_final")
    _close(hs, twin_hs, OUT_TOL, "hs")
    twin_bwd = A.augru_scan_bwd_plain(a["u_rz"], a["u_h"], x, a["att"], twin_hs, a["g_fin"])
    for name, g, r in zip(("dx", "ops", "datt", "dh0"), bwd, twin_bwd):
        _close(g, r, GRAD_TOL, name)
    hf2, hs2 = A.augru_scan_fwd(a["u_rz"], a["u_h"], x, a["att"])
    assert torch.equal(hf, hf2) and torch.equal(hs, hs2)
    for g, r in zip(bwd, A.augru_scan_bwd(a["u_rz"], a["u_h"], x, a["att"], hs, a["g_fin"])):
        assert torch.equal(g, r)


@pytest.mark.cuda
def test_functions_on_the_card_match_the_plain_loop(cuda_device):
    """The autograd Functions on the card against the plain loop on the
    card: outputs and every gradient."""
    a = _inputs(257, 64, 10, seed=9, device=cuda_device)
    (hs, grads), (ref, ref_grads) = _gru_both(a)
    _close(hs, ref, OUT_TOL, "hs")
    for name, g, r in zip(("gx", "recurrent"), grads, ref_grads):
        _close(g, r, GRAD_TOL, name)
    (hf, grads), (ref, ref_grads) = _augru_both(a)
    _close(hf, ref, OUT_TOL, "h_final")
    for name, g, r in zip(("x_all", "u_rz", "u_h", "att"), grads, ref_grads):
        _close(g, r, GRAD_TOL, name)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    a = _inputs(4, 3, 10, device=cuda_device)
    with pytest.raises(ValueError):
        A.gru_scan_fwd(a["u"], a["gx"], a["mask"].float())
    with pytest.raises(ValueError):
        A.gru_scan_fwd(a["u"][:, :20].contiguous(), a["gx"], a["mask"])
    with pytest.raises(ValueError):
        A.augru_scan_fwd(a["u_rz"], a["u_h"], a["gx"].double(), a["att"])
    wide = _inputs(4, 3, 33, device=cuda_device)
    with pytest.raises(ValueError):
        A.gru_scan_fwd(wide["u"], wide["gx"], wide["mask"])


@pytest.mark.cuda
def test_dien_training_step_launches_each_scan_once(cuda_device):
    """A DIEN `Trainer._train_step` on the card at T = 64: each scan kernel
    once a step."""
    from sparrowrecsys_torch.config import TrainConfig
    from sparrowrecsys_torch.models.dien import DIEN, dien_loss_fn
    from sparrowrecsys_torch.ops import metrics as M
    from sparrowrecsys_torch.training.loop import Trainer

    t = 64
    model = DIEN(dim=10, movie_buckets=1001, user_buckets=300, recent_movies=t)
    trainer = Trainer(model, TrainConfig(batch_size=256, epochs=1),
                      loss_fn=dien_loss_fn(recent_movies=t, movie_vocab=1001), device="cuda")
    params, opt_state = trainer.prepare(trainer.init_params(seed=2))
    feats, labels = _dien_batch(256, t, 1001, 300)
    feats = {k: v.to(cuda_device) for k, v in feats.items()}
    names = ("gru_scan_fwd", "gru_scan_bwd", "augru_scan_fwd", "augru_scan_bwd")
    before = kernels.launch_counts()
    mstate = M.init_metrics("cuda")
    for _ in range(2):
        params, opt_state, mstate = trainer._train_step(
            params, opt_state, mstate, feats, labels.to(cuda_device), torch.ones(256,
                                                                                  device="cuda"))
    torch.cuda.synchronize()
    assert {n: _ran(before).get(n) for n in names} == dict.fromkeys(names, 2)
    assert all(torch.isfinite(v).all() for v in params.values())

"""The DIN kernels' tensor-core arithmetic on the CPU, against the JAX package.

The kernels compute the unit's per-step product [h, h*c] @ [wa+wb; wd]
and the backward's dapre @ [wa+wb; wd]^T with TF32 tensor-core
instructions, every operand split into two TF32 parts and three products
summed in float32 (`tf32_split_product_plain` is that arithmetic in plain
PyTorch). Here it goes through the whole unit beside JAX's `_unit` on the
same seeded inputs: the pre-activations and the outputs agree within the
kernels' own gate, 1e-5 of scale. One pass of TF32 (hi*hi alone) misses
that gate, and the gates `tools/kernel_bench.py` holds the card's kernels
to: the forward's out at 1e-5 of scale and dh at 1e-4, which is why the
split exists.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparrowrecsys_torch.ops.attention import (
    _fold,
    _tf32,
    din_attention_bwd_plain,
    din_attention_bwd_steps_plain,
    din_attention_plain,
    tf32_split_product_plain,
)
from sparrowrecsys_tpu.ops import attention as jax_attention

torch.set_num_threads(2)

#: kernel_bench's DIN shapes at B = 64 (serving and training, the long
#: history, D=128 with H=64), D = 3, 12 and 700 and H = 1, 24 and 100.
SHAPES = [(64, 5, 10, 32), (64, 64, 128, 32), (64, 5, 128, 64), (64, 5, 3, 32), (64, 5, 12, 32),
          (8, 4, 700, 12), (64, 5, 10, 1), (64, 5, 10, 24), (64, 5, 10, 100)]
#: The gate of the kernels against their plain versions.
GATE = 1e-5


def _inputs(b, t, d, h, seed=0):
    """Masked steps (all-zero rows), a row with no history and a zero
    element that does not mask, the weights at the trainer's scale."""
    rng = np.random.default_rng(seed)
    hist = rng.normal(size=(b, t, d)).astype(np.float32)
    hist[:, t // 2 + 1:] = 0.0
    hist[0] = 0.0
    hist[1, 0, 0] = 0.0
    return [
        hist,
        rng.normal(size=(b, d)).astype(np.float32),
        (rng.normal(size=(4 * d, h)) / np.sqrt(4 * d)).astype(np.float32),
        (rng.normal(size=(h,)) * 0.1).astype(np.float32),
        (rng.normal(size=(h,)) * 0.1).astype(np.float32),
        (rng.normal(size=(h, 1)) / np.sqrt(h)).astype(np.float32),
        (rng.normal(size=(1,)) * 0.1).astype(np.float32),
    ]


def _jax_preactivations(hist, cand, w1, b1):
    """`_unit`'s pre-activations [B, T, H], its own lines in jnp: the
    folded product in float32 on the CPU."""
    d = hist.shape[-1]
    wa, wb, wc, wd = w1[:d], w1[d:2 * d], w1[2 * d:3 * d], w1[3 * d:]
    ce = jnp.broadcast_to(cand[..., None, :], hist.shape)
    feats = jnp.concatenate([hist, ce, hist * ce], axis=-1)
    wk = jnp.concatenate([wa + wb, wc - wa, wd], axis=0)
    return jnp.dot(feats, wk, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST) + b1


def _single_pass(a, b):
    return _tf32(a.float()) @ _tf32(b.float())


def _tile_unit(hist, cand, w1, b1, alpha, w2, b2, product=tf32_split_product_plain):
    """The unit as the kernels' tile computes it: the per-step product
    [h, h*c] @ [wa+wb; wd] through `product`, the candidate's term
    c @ (wc-wa) + b1 once per row in float32, then PReLU, w2, b2, sigmoid,
    the all-zero mask and the pooling. Returns (pre-activations, out)."""
    b, t, d = hist.shape
    wk = _fold(w1, d)
    ce = cand[:, None, :].expand_as(hist)
    x = torch.cat([hist, hist * ce], -1).reshape(b * t, 2 * d)
    pre = product(x, torch.cat([wk[:d], wk[2 * d:]], 0)).reshape(b, t, -1)
    pre = pre + (cand @ wk[d:2 * d] + b1)[:, None, :]
    a = torch.where(pre >= 0, pre, alpha * pre)
    w = torch.sigmoid(a @ w2 + b2) * (hist != 0).any(-1, keepdim=True)
    return pre, (w * hist).sum(1)


def _tile_dh(hist, cand, w1, b1, alpha, w2, b2, g, product=tf32_split_product_plain):
    """dh as the backward's tile computes it: w g + dapre @ [wa+wb; wd]^T
    through `product`, the h*c half's share times c; dapre and the step
    weights w in float32 as the plain version forms them."""
    b, t, d = hist.shape
    wk = _fold(w1, d)
    dapre = din_attention_bwd_steps_plain(hist, cand, w1, b1, alpha, w2, b2, g)[2]
    f = product(dapre, torch.cat([wk[:d], wk[2 * d:]], 0).T)                # [B*T, 2D]
    ce = cand[:, None, :].expand_as(hist)
    pre = torch.cat([hist, ce, hist * ce], -1) @ wk + b1
    a = torch.where(pre >= 0, pre, alpha * pre)
    w = torch.sigmoid(a @ w2 + b2) * (hist != 0).any(-1, keepdim=True)      # [B, T, 1]
    return w * g[:, None, :] + f[:, :d].reshape(b, t, d) + ce * f[:, d:].reshape(b, t, d)


def _card_inputs(b, t, d, h):
    """`kernel_bench`'s DIN inputs on the CPU: a third of the steps
    all-zero, the weights at the trainer's scale, an output gradient."""
    g = torch.Generator().manual_seed(1)
    hist = torch.randn(b, t, d, generator=g)
    hist = hist.masked_fill(torch.rand(b, t, 1, generator=g) < 0.3, 0.0)
    return (hist, torch.randn(b, d, generator=g),
            torch.randn(4 * d, h, generator=g) / (4 * d) ** 0.5,
            torch.randn(h, generator=g) * 0.1, torch.randn(h, generator=g) * 0.1,
            torch.randn(h, 1, generator=g) / h ** 0.5, torch.randn(1, generator=g) * 0.1,
            torch.randn(b, d, generator=g))


def _within_gate(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    tol = GATE * np.abs(ref) + GATE * max(1.0, np.abs(ref).max())
    return bool(np.all(np.abs(got - ref) <= tol))


def test_tf32_rounds_to_nearest_ties_away_from_zero():
    """Every result has its low 13 bits clear and is the TF32 value
    nearest x (in float64), a tie going away from zero; infinities and
    NaNs pass."""
    ties = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11, 2.0 ** -11 + 1],
                    np.float32)
    assert _tf32(torch.from_numpy(ties)).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10),
                                                      1 + 2 * 2.0 ** -10, 1 + 2.0 ** -10]
    rng = np.random.default_rng(3)
    x = (rng.normal(size=20000) * 10.0 ** rng.integers(-30, 30, 20000)).astype(np.float32)
    r = _tf32(torch.from_numpy(x)).numpy()
    assert not np.any(r.view(np.uint32) & 0x1FFF)
    trunc = (x.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32).astype(np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(trunc))) - 10)
    away = trunc + np.sign(x) * ulp
    xd = x.astype(np.float64)
    want = np.where(np.abs(xd - trunc) < np.abs(away - xd), trunc, away)
    np.testing.assert_array_equal(r.astype(np.float64), want)
    special = torch.tensor([float("inf"), -float("inf"), float("nan"), 0.0, -0.0])
    out = _tf32(special)
    assert out[:2].tolist() == [float("inf"), -float("inf")] and bool(out[2].isnan())
    assert out[3:].tolist() == [0.0, -0.0]


@pytest.mark.parametrize("m,k,n", [(64, 20, 32), (16, 256, 8), (7, 1400, 12)])
def test_split_product_keeps_float32_accuracy(m, k, n):
    """Three TF32 products lose only lo*lo, below float32's last bit:
    within a few float32 roundings of the float64 product per term; one
    TF32 pass is off by TF32's own rounding, some hundred times more."""
    rng = np.random.default_rng(k)
    a, b = rng.normal(size=(m, k)).astype(np.float32), rng.normal(size=(k, n)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    split_err = np.abs(tf32_split_product_plain(ta, tb).numpy() - ref) / scale
    single_err = np.abs(_single_pass(ta, tb).numpy() - ref) / scale
    assert split_err.max() < 2.0 ** -20
    assert single_err.max() > 2.0 ** -16


@pytest.mark.parametrize("b,t,d,h", SHAPES)
def test_split_tile_matches_jax_unit_within_the_kernel_gate(b, t, d, h):
    args = _inputs(b, t, d, h)
    jargs = [jnp.asarray(a) for a in args]
    ref_out = np.asarray(jax_attention._unit(*jargs))
    ref_pre = np.asarray(_jax_preactivations(*jargs[:4]))
    pre, out = _tile_unit(*[torch.from_numpy(a) for a in args])
    assert pre.shape == ref_pre.shape and out.shape == ref_out.shape
    assert _within_gate(pre.numpy(), ref_pre), np.abs(pre.numpy() - ref_pre).max()
    assert _within_gate(out.numpy(), ref_out), np.abs(out.numpy() - ref_out).max()
    # The plain forward (float32 matmuls) is the card's reference; the
    # tile agrees with it too.
    plain = din_attention_plain(*[torch.from_numpy(a) for a in args]).numpy()
    assert _within_gate(out.numpy(), plain)


@pytest.mark.parametrize("b,t,d,h", [(64, 5, 10, 32), (64, 64, 128, 32), (64, 5, 128, 64),
                                     (8192, 5, 10, 32), (65536, 5, 10, 32), (512, 64, 128, 32)])
def test_single_pass_tf32_misses_the_gate(b, t, d, h):
    """hi*hi alone: the pre-activations miss 1e-5 of scale against JAX;
    and on kernel_bench's inputs, the forward's out misses its card gate
    (1e-5 relative and of scale) and dh its own (1e-4 relative and of
    scale), where the split passes both."""
    args = _inputs(b, t, d, h)
    ref_pre = np.asarray(_jax_preactivations(*[jnp.asarray(a) for a in args[:4]]))
    pre, _ = _tile_unit(*[torch.from_numpy(a) for a in args], product=_single_pass)
    assert not _within_gate(pre.numpy(), ref_pre)
    *unit, go = _card_inputs(b, t, d, h)
    ref = din_attention_plain(*unit)
    atol = 1e-5 * ref.abs().max().item()
    assert torch.allclose(_tile_unit(*unit)[1], ref, rtol=1e-5, atol=atol)
    assert not torch.allclose(_tile_unit(*unit, product=_single_pass)[1], ref, rtol=1e-5,
                              atol=atol)
    dh = din_attention_bwd_plain(*unit, go)[0]
    atol = 1e-4 * max(dh.abs().max().item(), 1.0)
    assert torch.allclose(_tile_dh(*unit, go), dh, rtol=1e-4, atol=atol)
    assert not torch.allclose(_tile_dh(*unit, go, product=_single_pass), dh, rtol=1e-4,
                              atol=atol)

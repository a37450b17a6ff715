"""DIN at shapes the card's first kernels refused (H outside 8/16/32/64,
T above 256, wide D), on the CPU against the JAX package.

The backward the port runs is the per-step terms
(`din_attention_bwd_steps_plain`, the plain version of the per-step
kernel) composed with `_din_weight_grads`, the wrapper's own product code
for the three [D, H] weight gradients; it is held against `jax.vjp` of
`_unit`, which XLA computes with dot products. The kernels' launch plan
(`plan`) is checked to cover every shape in chunks of H the kernels are
built for, within the H100's shared memory. The kernels themselves are
held against the plain versions on the card (tests/test_torch_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparrowrecsys_torch.ops.attention import (
    KERNEL_CHUNKS,
    MAX_THREADS,
    PRODUCT_SLICES,
    WEIGHT_BYTES,
    _din_weight_grads,
    _tn,
    din_attention,
    din_attention_bwd,
    din_attention_bwd_plain,
    din_attention_bwd_steps_plain,
    din_attention_plain,
    plan,
)
from sparrowrecsys_tpu.ops import attention as jax_attention

torch.set_num_threads(2)

GRAD_NAMES = ("dh", "dc", "dw1", "db1", "dalpha", "dw2", "db2")
#: The shapes of the issue that raised on the card: H=24, T=300, H=100,
#: H=1 (below the narrowest chunk), and two more.
SHAPES = [(8, 5, 10, 24), (4, 300, 6, 8), (6, 5, 12, 100), (3, 4, 5, 1), (5, 3, 7, 64),
          (2, 6, 3, 130)]
#: The H100's shared memory a block may use, in bytes.
H100_BLOCK_SHARED = 232_448


def _inputs(b, t, d, h, seed=0):
    """Masked steps (all-zero rows), a row with no history and a zero
    element that does not mask, as the other DIN tests build them."""
    rng = np.random.default_rng(seed)
    hist = rng.normal(size=(b, t, d)).astype(np.float32)
    hist[:, t // 2 + 1:] = 0.0
    hist[0] = 0.0
    hist[1, 0, 0] = 0.0
    args = [
        hist,
        rng.normal(size=(b, d)).astype(np.float32),
        (rng.normal(size=(4 * d, h)) * 0.5).astype(np.float32),
        (rng.normal(size=(h,)) * 0.1).astype(np.float32),
        (rng.normal(size=(h,)) * 0.1).astype(np.float32),
        (rng.normal(size=(h, 1)) * 0.5).astype(np.float32),
        (rng.normal(size=(1,)) * 0.1).astype(np.float32),
    ]
    return args, rng.normal(size=(b, d)).astype(np.float32)


def _pad_hidden(w1, b1, alpha, w2, width):
    """The four H-wide weights with zero columns up to `width`, as the
    kernels read them past H."""
    n = width - w1.shape[-1]
    pad = torch.nn.functional.pad
    return pad(w1, (0, n)), pad(b1, (0, n)), pad(alpha, (0, n)), pad(w2, (0, 0, 0, n))


def _assert_grads(got, ref, tol=1e-5):
    """float32 in another summation order over B*T: 1e-5 relative and
    1e-5 of each gradient's scale absolute."""
    for name, a, r in zip(GRAD_NAMES, got, ref):
        a, r = np.asarray(a), np.asarray(r)
        assert a.shape == r.shape, name
        np.testing.assert_allclose(a, r, rtol=tol, atol=tol * max(1.0, np.abs(r).max()),
                                   err_msg=name)


@pytest.mark.parametrize("b,t,d,h", SHAPES)
def test_steps_and_weight_products_match_the_jax_vjp_of_unit(b, t, d, h):
    args, g = _inputs(b, t, d, h)
    _, vjp = jax.vjp(jax_attention._unit, *[jnp.asarray(a) for a in args])
    ref = vjp(jnp.asarray(g))
    targs = [torch.from_numpy(a) for a in args]
    dh, dc, dapre, hx, dsum, small = din_attention_bwd_steps_plain(*targs, torch.from_numpy(g))
    assert dapre.shape == (b * t, h) and hx.shape == (b * t, 2 * d) and dsum.shape == (b, h)
    dw1 = _din_weight_grads(hx, dapre, targs[1], dsum)
    got = (dh, dc, dw1, small[:h], small[h:2 * h], small[2 * h:3 * h, None], small[3 * h:])
    _assert_grads([x.numpy() for x in got], ref)
    # The wrapper on the CPU is that composition, and the reference agrees.
    wrapped = din_attention_bwd(*targs, torch.from_numpy(g))
    for x, y in zip(wrapped, got):
        assert torch.equal(x, y)
    _assert_grads([x.numpy() for x in din_attention_bwd_plain(*targs, torch.from_numpy(g))], ref)


@pytest.mark.parametrize("n", [0, 7, PRODUCT_SLICES, 2 * PRODUCT_SLICES + 176])
def test_sliced_product_equals_one_product(n):
    """`_tn` over whole slices plus the rows past the last one, in
    float64 so that only a wrong row split could tell the two apart."""
    rng = np.random.default_rng(n)
    a, b = torch.from_numpy(rng.normal(size=(n, 5))), torch.from_numpy(rng.normal(size=(n, 3)))
    np.testing.assert_allclose(_tn(a, b).numpy(), (a.T @ b).numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("b,t,d,h", SHAPES)
def test_the_function_on_the_cpu_matches_autograd_of_the_plain_forward(b, t, d, h):
    args, g = _inputs(b, t, d, h, seed=1)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    got = torch.autograd.grad(din_attention(*leaves), leaves, torch.from_numpy(g))
    ref_leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    ref = torch.autograd.grad(din_attention_plain(*ref_leaves), ref_leaves, torch.from_numpy(g))
    _assert_grads([x.numpy() for x in got], [r.numpy() for r in ref])


@pytest.mark.parametrize("h", [24, 100])
def test_forward_with_zero_padded_weights_equals_xla_on_the_unpadded_ones(h):
    """Zero columns up to the kernels' width (the plan's chunks) change
    nothing: a zero column's pre-activation, PReLU and w2 are 0."""
    b, t, d = 6, 5, 10
    args, _ = _inputs(b, t, d, h, seed=2)
    ref = np.asarray(jax_attention.din_attention_xla(*[jnp.asarray(a) for a in args]))
    p = plan(t, d, h)
    width = p.chunks * p.hc
    assert width > h
    targs = [torch.from_numpy(a) for a in args]
    padded = _pad_hidden(*targs[2:6], width)
    assert padded[0].shape == (4 * d, width) and padded[3].shape == (width, 1)
    got = din_attention_plain(targs[0], targs[1], *padded, targs[6]).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def _shared_bytes(p, t, d):
    """A block's shared memory on this plan, forward and backward, as
    `fwd_shared_bytes` and `bwd_shared_bytes` of the .cu count it."""
    weights = 0 if p.weights_global else 3 * d * (p.hc + 4)
    common = weights + 3 * p.hc + p.rows * (p.hc + 1)
    fwd = common + (0 if p.step_weights_global else p.rows * t)
    fwd += p.rows * (t + 1) * (d | 1) if p.staged else 0
    bwd = common + p.rows * (p.hc + 1) + p.threads * ((1 if p.staged else 2) * (p.hc + 1) + 1)
    bwd += (p.rows * (t + 2) + p.threads) * (d | 1) if p.staged else 0
    return 4 * fwd, 4 * bwd


@pytest.mark.parametrize("t,d,h", [
    (5, 10, 32), (64, 128, 32), (5, 128, 64), (256, 128, 32), (300, 16, 32), (5, 10, 24),
    (5, 10, 100), (5, 512, 64), (3, 700, 12), (1, 1, 1), (20000, 4, 8), (7, 3000, 200),
    (1, 4096, 0), (200, 10, 64), (1, 10, 64),
])
def test_plan_covers_every_shape_within_shared_memory(t, d, h):
    p = plan(t, d, h)
    assert p.hc in KERNEL_CHUNKS
    assert p.chunks >= 1 and p.chunks * p.hc >= h and (p.chunks - 1) * p.hc < max(h, 1)
    natural = min(w for w in KERNEL_CHUNKS if w >= min(h, 64))
    assert p.hc == natural or 3 * d * (2 * p.hc + 4) * 4 > WEIGHT_BYTES
    assert 32 <= p.threads <= MAX_THREADS and p.threads % 32 == 0
    assert p.rows >= 1 and (p.rows == 1 or p.rows * t <= p.threads)
    assert not (p.staged and p.weights_global)
    assert p.weights_global == (3 * d * (8 + 4) * 4 > WEIGHT_BYTES)
    fwd, bwd = _shared_bytes(p, t, d)
    assert fwd <= H100_BLOCK_SHARED and bwd <= H100_BLOCK_SHARED


def test_plan_at_the_paths_shapes():
    """Serving and training (T=5, D=10, H=32): one chunk of 32, 25 rows a
    block, the tile staged; [65536, 64, 128] reads its history from
    global memory; D=128, H=64 and D=512 split H into chunks."""
    assert plan(5, 10, 32) == (32, 1, 25, 128, True, False, False)
    assert plan(64, 128, 32)[:5] == (32, 1, 2, 128, False)
    assert plan(5, 128, 64)[:2] == (32, 2)
    assert plan(5, 512, 64)[:2] == (8, 8)
    assert plan(4, 700, 12)[5]

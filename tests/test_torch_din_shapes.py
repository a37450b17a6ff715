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
    CT_STEPS,
    PRODUCT_SLICES,
    SHARED_BYTES,
    WARPS,
    _din_weight_grads,
    _tn,
    din_attention,
    din_attention_bwd,
    din_attention_bwd_narrow_plain,
    din_attention_bwd_plain,
    din_attention_bwd_steps_plain,
    din_attention_plain,
    hx_alone,
    narrow,
    narrow_partial_width,
    plan,
    shared_floats,
    unit_rows,
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
    hx_width = d if hx_alone(d, h) else 2 * d
    assert dapre.shape == (b * t, h) and hx.shape == (b * t, hx_width) and dsum.shape == (b, h)
    dw1 = _din_weight_grads(hx, dapre, targs[1], dsum, targs[0])
    got = (dh, dc, dw1, small[:h], small[h:2 * h], small[2 * h:3 * h, None], small[3 * h:])
    _assert_grads([x.numpy() for x in got], ref)
    # The wrapper on the CPU is that composition, and the reference agrees.
    wrapped = din_attention_bwd(*targs, torch.from_numpy(g))
    for x, y in zip(wrapped, got):
        assert torch.equal(x, y)
    _assert_grads([x.numpy() for x in din_attention_bwd_plain(*targs, torch.from_numpy(g))], ref)


@pytest.mark.parametrize("b,t,d,h", [(6, 5, 12, 8), (4, 7, 20, 3), (3, 4, 5, 1)])
def test_hc_alone_where_d_exceeds_h_matches_the_jax_vjp_of_unit(b, t, d, h):
    """Where D > H the per-step terms carry h*c alone [B*T, D], and the
    weight products take dk0 = h^T dapre from the history itself; the
    seven gradients still equal `jax.vjp(_unit)`'s."""
    assert hx_alone(d, h)
    args, g = _inputs(b, t, d, h, seed=3)
    _, vjp = jax.vjp(jax_attention._unit, *[jnp.asarray(a) for a in args])
    ref = vjp(jnp.asarray(g))
    targs = [torch.from_numpy(a) for a in args]
    dh, dc, dapre, hc, dsum, small = din_attention_bwd_steps_plain(*targs, torch.from_numpy(g))
    assert hc.shape == (b * t, d)
    assert torch.equal(hc, (targs[0] * targs[1][:, None, :]).reshape(b * t, d))
    dw1 = _din_weight_grads(hc, dapre, targs[1], dsum, targs[0])
    got = (dh, dc, dw1, small[:h], small[h:2 * h], small[2 * h:3 * h, None], small[3 * h:])
    _assert_grads([x.numpy() for x in got], ref)


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
    width = p.chunks * p.nt * 8
    assert width > h
    targs = [torch.from_numpy(a) for a in args]
    padded = _pad_hidden(*targs[2:6], width)
    assert padded[0].shape == (4 * d, width) and padded[3].shape == (width, 1)
    got = din_attention_plain(targs[0], targs[1], *padded, targs[6]).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("t,d,h", [
    (5, 10, 32), (64, 128, 32), (5, 128, 64), (256, 128, 32), (300, 16, 32), (5, 10, 24),
    (5, 10, 100), (5, 512, 64), (3, 700, 12), (1, 1, 1), (20000, 4, 8), (7, 3000, 200),
    (1, 4096, 0), (200, 10, 64), (1, 10, 64),
])
def test_plan_covers_every_shape_within_shared_memory(t, d, h):
    """Forward and backward: H in chunks of nt tiles of 8 columns that
    cover it (the last chunk reaching past H), a chunk of 16 * warps steps
    of whole rows (one row's where T exceeds it), D in slices that cover
    it, wc - wa in shared memory only over one slice, the candidate's term
    in the product only over one slice of a short history, and the block's
    shared memory, as the .cu lays it out, within the H100's 227 KB."""
    kst = -(-d // 8)
    for backward in (False, True):
        p = plan(t, d, h, backward)
        assert p.warps in WARPS and p.nt in (1, 2, 4, 8)
        assert p.chunks * p.nt * 8 >= h and (p.chunks - 1) * p.nt * 8 < max(h, 1)
        assert p.nt == 8 or p.chunks == 1
        m = 16 * p.warps
        assert p.rows == max(1, m // t) and (p.rows == 1 or p.rows * t <= m)
        assert p.slices == -(-kst // p.slice_steps) and (p.slices - 1) * p.slice_steps < kst
        assert not (p.wc_shared and p.slices > 1)
        assert not (p.ct and (p.wc_shared or p.slices > 1 or t > CT_STEPS))
        assert p.shared_bytes == 4 * shared_floats(t, d, h, p.warps, p.slice_steps, p.wc_shared,
                                                   backward, p.ct)
        assert p.shared_bytes <= SHARED_BYTES == 232_448


def test_plan_at_the_paths_shapes():
    """Serving and training (T=5, D=10, H=32): 8 warps, 25 rows (125 of
    128 steps) a chunk, one chunk of 4 tiles of H, D in one slice, the
    candidate's term in the product. [65536, 64, 128]: the forward 8 warps
    of 2 rows; the backward (its pre-activations and dsum beside the
    forward's regions) 4 warps of one row, to keep wc - wa in shared
    memory; the candidate's term once per row. D=128 with H=64 takes 2
    warps (the term in the product would fit one), D=512 slices of D."""
    assert plan(5, 10, 32) == (8, 25, 4, 1, 2, 1, False, True, 27936)
    assert plan(5, 10, 32, True) == (8, 25, 4, 1, 2, 1, False, True, 57152)
    assert plan(64, 128, 32) == (8, 2, 4, 1, 16, 1, True, False, 224512)
    assert plan(64, 128, 32, True) == (4, 1, 4, 1, 16, 1, True, False, 168496)
    assert plan(5, 128, 64)[:8] == (2, 6, 8, 1, 16, 1, True, False)
    assert plan(5, 512, 64)[:8] == (2, 6, 8, 1, 16, 4, False, False)


@pytest.mark.parametrize("d,h,takes_narrow", [
    (10, 32, True), (16, 32, True), (17, 32, False), (10, 64, False), (128, 32, False),
])
def test_the_path_rule_reads_d_and_h_alone(d, h, takes_narrow):
    """D <= 16 and H <= 32 take the narrow kernels (csrc/din_narrow.cu);
    every other shape the tensor cores' (csrc/din_attention.cu)."""
    assert narrow(d, h) is takes_narrow


@pytest.mark.parametrize("b,t,rows", [(131072, 64, 64), (65536, 5, 32), (8192, 5, 4),
                                      (2, 9000, 1), (7, 5, 1), (1, 1, 1)])
def test_units_follow_b_and_t_alone(b, t, rows):
    """At most 4,096 steps a unit (one row where T is longer), and about
    2,048 units or fewer where B is small; the partial is three planes of
    [D + 1, 32] and db2, padded to 32 floats."""
    assert unit_rows(b, t) == rows
    assert -(-b // rows) <= 2048 or rows == 1
    assert narrow_partial_width(10) == 1088 and narrow_partial_width(10) % 32 == 0


@pytest.mark.parametrize("t", [5, 64])
@pytest.mark.parametrize("rows", [None, 3])
def test_narrow_backward_twin_matches_the_jax_vjp_of_unit(t, rows):
    """The narrow backward's arithmetic and order of summation (the
    candidate folded per row, R_b per row, per-unit partials reduced in the
    kernel's fixed order) against `jax.vjp(_unit)` at D = 10, H = 32, with
    masked steps (the second half of every row), an all-masked row and a
    zero element that does not mask; units of one row (`unit_rows` at this
    B) and of 3 rows (the last unit short)."""
    b, d, h = 8, 10, 32
    args, g = _inputs(b, t, d, h, seed=5)
    _, vjp = jax.vjp(jax_attention._unit, *[jnp.asarray(a) for a in args])
    ref = vjp(jnp.asarray(g))
    targs = [torch.from_numpy(a) for a in args]
    got = din_attention_bwd_narrow_plain(*targs, torch.from_numpy(g), rows=rows)
    _assert_grads([x.numpy() for x in got], ref)
    assert not got[0][0].any() and not got[1][0].any()          # the all-masked row
    assert not got[0][:, t // 2 + 1:].any()                      # masked steps
    again = din_attention_bwd_narrow_plain(*targs, torch.from_numpy(g), rows=rows)
    assert all(torch.equal(x, y) for x, y in zip(got, again))

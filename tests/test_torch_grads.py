"""The port's backward passes against the JAX package's, on the same
numpy inputs: `fm_cross_bwd_plain` and `din_attention_bwd_plain` (the
plain versions of the CUDA backward kernels) against the JAX VJPs, the
Pallas kernels' custom VJPs in interpret mode included, and the
`autograd.Function` wrappers on the CPU against autograd of the plain
forwards. The kernels themselves are held against these plain versions
on the card (tests/test_torch_kernels.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sparrowrecsys_torch.ops import kernels
from sparrowrecsys_torch.ops.attention import (
    din_attention,
    din_attention_bwd,
    din_attention_bwd_plain,
    din_attention_plain,
)
from sparrowrecsys_torch.ops.fm import fm_cross, fm_cross_bwd, fm_cross_bwd_plain, fm_cross_plain
from sparrowrecsys_tpu.ops import attention as jax_attention
from sparrowrecsys_tpu.ops import fm as jax_fm

torch.set_num_threads(2)

GRAD_NAMES = ("dh", "dc", "dw1", "db1", "dalpha", "dw2", "db2")


def _din_inputs(b=8, t=8, d=4, h=8, seed=0, zero_preact=False):
    """The masked-step inputs of test_torch_ops.py; with `zero_preact`,
    pre-activation column 0 is exactly 0 at every step (b1[0] = 0 and
    w1[:, 0] = 0), where the PReLU's gradient takes the identity branch."""
    rng = np.random.default_rng(seed)
    hist = rng.normal(size=(b, t, d)).astype(np.float32)
    hist[:, t // 2:] = 0.0            # padded steps: all-zero rows
    hist[0, 1] = 0.0
    hist[1, 0, 0] = 0.0               # a zero element alone does not mask
    args = [
        hist,
        rng.normal(size=(b, d)).astype(np.float32),
        rng.normal(size=(4 * d, h)).astype(np.float32) * 0.5,
        rng.normal(size=(h,)).astype(np.float32) * 0.1,
        rng.normal(size=(h,)).astype(np.float32) * 0.1,
        rng.normal(size=(h, 1)).astype(np.float32) * 0.5,
        rng.normal(size=(1,)).astype(np.float32) * 0.1,
    ]
    if zero_preact:
        args[2][:, 0] = 0.0
        args[3][0] = 0.0
    g = rng.normal(size=(b, d)).astype(np.float32)
    return args, g


def _assert_grads(got, ref, rtol=1e-5, atol=1e-5):
    """float32 in another summation order over B*T: 1e-5 relative and
    1e-5 of each gradient's scale absolute."""
    for name, a, r in zip(GRAD_NAMES, got, ref):
        a, r = np.asarray(a), np.asarray(r)
        assert a.shape == r.shape, name
        np.testing.assert_allclose(a, r, rtol=rtol, atol=atol * max(1.0, np.abs(r).max()),
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fm_cross_bwd_plain_matches_jax(dtype):
    """float32: 1e-6; bfloat16: JAX sums and scales in bf16 where the port
    works in float32 and rounds once, a few bf16 ulps (2e-2 of scale)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 5, 16)).astype(np.float32)
    g = rng.normal(size=(64, 16)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    ref = np.asarray(jax_fm.fm_cross_bwd(jnp.asarray(x, jdt), jnp.asarray(g, jdt)), np.float32)
    tdt = getattr(torch, dtype)
    got = fm_cross_bwd_plain(torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt))
    assert got.dtype == tdt
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol,
                               atol=tol * np.abs(ref).max())


def test_fm_cross_bwd_plain_matches_the_pallas_vjp_in_interpret_mode():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(256, 5, 64)).astype(np.float32)
    g = rng.normal(size=(256, 64)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jax_fm.fm_cross_pallas, jnp.asarray(x))
        (ref,) = vjp(jnp.asarray(g))
    got = fm_cross_bwd_plain(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6, atol=1e-5)


def test_fm_cross_function_on_the_cpu_takes_the_plain_backward():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(32, 5, 8)).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(32, 8)).astype(np.float32))
    before = kernels.launch_counts()
    out = fm_cross(x)
    assert out.grad_fn is not None
    (dx,) = torch.autograd.grad(out, x, g)
    xr = x.detach().requires_grad_()
    (ref,) = torch.autograd.grad(fm_cross_plain(xr), xr, g)
    torch.testing.assert_close(dx, ref, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(fm_cross_bwd(x.detach(), g), fm_cross_bwd_plain(x.detach(), g))
    assert kernels.launch_counts() == before   # no kernel


@pytest.mark.parametrize("zero_preact", [False, True], ids=["masked", "zero_preact"])
def test_din_attention_bwd_plain_matches_jax_vjp_of_unit(zero_preact):
    args, g = _din_inputs(zero_preact=zero_preact)
    _, vjp = jax.vjp(jax_attention._unit, *[jnp.asarray(a) for a in args])
    ref = vjp(jnp.asarray(g))
    got = din_attention_bwd_plain(*[torch.from_numpy(a) for a in args], torch.from_numpy(g))
    _assert_grads([x.numpy() for x in got], ref)
    if zero_preact:
        # At exactly 0 the gradient takes the identity branch: no slope
        # gradient from column 0, and its bias gradient is not scaled.
        assert got[4][0].item() == 0.0 and float(np.asarray(ref[4])[0]) == 0.0
        assert got[3][0].item() != 0.0


def test_din_attention_bwd_plain_matches_the_fused_vjp_in_interpret_mode():
    args, g = _din_inputs(b=16, t=8, d=4, h=8, seed=3)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jax_attention._din_attention_fused, *[jnp.asarray(a) for a in args])
        ref = vjp(jnp.asarray(g))
    got = din_attention_bwd_plain(*[torch.from_numpy(a) for a in args], torch.from_numpy(g))
    _assert_grads([x.numpy() for x in got], ref)


@pytest.mark.parametrize("zero_preact", [False, True], ids=["masked", "zero_preact"])
def test_din_attention_bwd_plain_matches_autograd_of_the_plain_forward(zero_preact):
    args, g = _din_inputs(seed=4, zero_preact=zero_preact)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    ref = torch.autograd.grad(din_attention_plain(*leaves), leaves, torch.from_numpy(g))
    got = din_attention_bwd_plain(*[torch.from_numpy(a) for a in args], torch.from_numpy(g))
    _assert_grads([x.numpy() for x in got], [r.numpy() for r in ref])


def test_din_attention_function_on_the_cpu_and_bf16_history():
    """The Function's CPU backward is the plain one; bf16 history is cast
    up before it, and its gradient comes back in bf16."""
    args, g = _din_inputs(seed=5)
    t_args = [torch.from_numpy(a) for a in args]
    leaves = [a.clone().requires_grad_() for a in t_args]
    before = kernels.launch_counts()
    out = din_attention(*leaves)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    _assert_grads([x.numpy() for x in got],
                  [x.numpy() for x in din_attention_bwd(*t_args, torch.from_numpy(g))])
    bf = [t_args[0].bfloat16().requires_grad_(), t_args[1].bfloat16().requires_grad_()]
    dh, dc = torch.autograd.grad(din_attention(*bf, *t_args[2:]), bf, torch.from_numpy(g))
    assert dh.dtype == dc.dtype == torch.bfloat16
    ref = din_attention_bwd_plain(bf[0].detach(), bf[1].detach(), *t_args[2:], torch.from_numpy(g))
    torch.testing.assert_close(dh, ref[0].bfloat16())
    assert kernels.launch_counts() == before   # no kernel

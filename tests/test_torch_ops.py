"""The port's ops against the JAX package's, on the same numpy inputs.

The plain PyTorch versions are held against the XLA formulations and the
Pallas kernels in interpret mode (as tests/test_ops.py runs them on the
CPU). The hand-written CUDA kernels are held against the plain versions
on the card, in tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sparrowrecsys_torch.ops import kernels
from sparrowrecsys_torch.ops.attention import din_attention, din_attention_plain
from sparrowrecsys_torch.ops.embedding import embed_lookup
from sparrowrecsys_torch.ops.fm import fm_cross, fm_cross_plain
from sparrowrecsys_torch.ops.topk import cosine_scores, cosine_topk
from sparrowrecsys_tpu.ops import attention as jax_attention
from sparrowrecsys_tpu.ops import embedding as jax_embedding
from sparrowrecsys_tpu.ops import fm as jax_fm
from sparrowrecsys_tpu.ops import topk as jax_topk

torch.set_num_threads(2)

#: float32, same formula, different summation order: a few ulps.
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _din_inputs(b=8, t=8, d=4, h=8, seed=0):
    rng = np.random.default_rng(seed)
    hist = rng.normal(size=(b, t, d)).astype(np.float32)
    hist[:, t // 2:] = 0.0            # padded steps: all-zero rows
    hist[0, 1] = 0.0
    hist[1, 0, 0] = 0.0               # a zero element alone does not mask
    return [
        hist,
        rng.normal(size=(b, d)).astype(np.float32),
        rng.normal(size=(4 * d, h)).astype(np.float32) * 0.5,
        rng.normal(size=(h,)).astype(np.float32) * 0.1,
        rng.normal(size=(h,)).astype(np.float32) * 0.1,
        rng.normal(size=(h, 1)).astype(np.float32) * 0.5,
        rng.normal(size=(1,)).astype(np.float32) * 0.1,
    ]


@pytest.mark.parametrize("dim", [3, 64])
@pytest.mark.parametrize("mask_zero", [False, True])
def test_embed_lookup_matches_jax(dim, mask_zero):
    """dim 64 takes the JAX one-hot forward, dim 3 its gather."""
    rng = np.random.default_rng(1)
    table = rng.normal(size=(7, dim)).astype(np.float32)
    ids = np.array([[-1, 0, 1, 6], [7, 100, -5, 3]], np.int32)
    ref = np.asarray(jax_embedding.embed_lookup(jnp.asarray(table), jnp.asarray(ids),
                                                mask_zero=mask_zero))
    got = embed_lookup(torch.from_numpy(table), torch.from_numpy(ids), mask_zero=mask_zero)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not got[0, 0].any()                   # -1 is always zero
    assert bool(got[0, 1].any()) != mask_zero     # 0 only with mask_zero


def test_fm_cross_plain_matches_xla_and_pallas_interpret():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 5, 64)).astype(np.float32)
    got = fm_cross(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_fm.fm_cross_xla(jnp.asarray(x))), **F32_TOL)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jax_fm.fm_cross_pallas(jnp.asarray(x)))
    np.testing.assert_allclose(got, pallas, **F32_TOL)


def test_fm_cross_plain_bf16_keeps_dtype():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(16, 5, 8)).astype(np.float32))
    out = fm_cross_plain(x.bfloat16())
    assert out.dtype == torch.bfloat16
    ref = fm_cross_plain(x.bfloat16().float())
    torch.testing.assert_close(out.float(), ref, rtol=1e-2, atol=1e-2)


def test_din_attention_plain_matches_xla_and_pallas_interpret():
    args = _din_inputs()
    got = din_attention(*[torch.from_numpy(a) for a in args]).numpy()
    jargs = [jnp.asarray(a) for a in args]
    np.testing.assert_allclose(got, np.asarray(jax_attention.din_attention_xla(*jargs)), **F32_TOL)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jax_attention.din_attention_pallas(*jargs))
    np.testing.assert_allclose(got, pallas, **F32_TOL)


def test_din_attention_bf16_history_is_cast_up():
    args = [torch.from_numpy(a) for a in _din_inputs()]
    out = din_attention_plain(args[0].bfloat16(), args[1].bfloat16(), *args[2:])
    assert out.dtype == torch.float32
    ref = din_attention_plain(args[0].bfloat16().float(), args[1].bfloat16().float(), *args[2:])
    torch.testing.assert_close(out, ref)


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    before = kernels.launch_counts()
    x = torch.randn(4, 5, 8)
    torch.testing.assert_close(fm_cross(x), fm_cross_plain(x))
    args = [torch.from_numpy(a) for a in _din_inputs()]
    torch.testing.assert_close(din_attention(*args), din_attention_plain(*args))
    assert kernels.launch_counts() == before


def test_wrappers_raise_on_a_device_that_is_neither_cpu_nor_cuda():
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fm_cross(torch.empty(2, 5, 4, device="meta"))
    args = [torch.from_numpy(a).to("meta") for a in _din_inputs()]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        din_attention(*args)


def test_cosine_scores_and_topk_match_jax():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(3, 10)).astype(np.float32)
    items = rng.normal(size=(50, 10)).astype(np.float32)
    items[7] = 0.0
    ref = np.asarray(jax_topk.cosine_scores(jnp.asarray(q), jnp.asarray(items)))
    got = cosine_scores(torch.from_numpy(q), torch.from_numpy(items)).numpy()
    np.testing.assert_allclose(got, ref, **F32_TOL)
    _, ref_idx = jax_topk.cosine_topk(jnp.asarray(q), jnp.asarray(items), k=5)
    _, idx = cosine_topk(torch.from_numpy(q), torch.from_numpy(items), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))

"""The hand-written CUDA kernels against their plain PyTorch versions.

These run only on a CUDA card (a CUDA kernel has no CPU mode): every
test carries the `cuda` marker and skips without one. This file imports
no JAX, so the card's machine runs it without the JAX package's conftest:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from sparrowrecsys_torch.ops.attention import din_attention, din_attention_plain
from sparrowrecsys_torch.ops.fm import fm_cross, fm_cross_plain


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _din_inputs(b, t, d, h, device, seed=0):
    rng = np.random.default_rng(seed)
    hist = rng.normal(size=(b, t, d)).astype(np.float32)
    hist[:, t // 2:] = 0.0            # padded steps: all-zero rows
    hist[0, :] = 0.0                  # a row with no history at all
    hist[1, 0, 0] = 0.0               # a zero element alone does not mask
    arrays = [
        hist,
        rng.normal(size=(b, d)),
        rng.normal(size=(4 * d, h)) * 0.5,
        rng.normal(size=(h,)) * 0.1,
        rng.normal(size=(h,)) * 0.1,
        rng.normal(size=(h, 1)) * 0.5,
        rng.normal(size=(1,)) * 0.1,
    ]
    return [torch.from_numpy(np.asarray(a, np.float32)).to(device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape", [(8192, 5, 64), (100, 3, 10), (7, 5, 6), (0, 5, 8)])
def test_fm_cross_kernel_matches_plain(cuda_device, dtype, tol, shape):
    """float32: 1e-5 of the output's scale (summation order, one fma);
    bfloat16: 1e-2 (one rounding of the output)."""
    g = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(shape, generator=g).to(cuda_device, dtype)
    before = fm_cross.launches
    out = fm_cross(x)
    torch.cuda.synchronize()
    assert fm_cross.launches == before + (1 if shape[0] else 0)  # nothing to launch for B=0
    assert out.dtype == dtype and tuple(out.shape) == (shape[0], shape[2])
    ref = fm_cross_plain(x).float()
    scale = max(ref.abs().max().item(), 1.0) if ref.numel() else 1.0
    torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol * scale)


@pytest.mark.cuda
def test_fm_cross_kernel_on_unaligned_view(cuda_device):
    """A view 4 bytes off a 16-byte boundary takes the scalar path."""
    x = torch.randn(1 + 64 * 5 * 16, device=cuda_device)[1:].view(64, 5, 16)
    torch.testing.assert_close(fm_cross(x), fm_cross_plain(x), rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d,h", [
    (8192, 5, 10, 32), (8, 8, 4, 8), (33, 130, 12, 16), (5, 1, 3, 64), (300, 64, 128, 32),
])
def test_din_attention_kernel_matches_plain(cuda_device, b, t, d, h):
    """float32, another summation order than cuBLAS over 3D*H terms:
    1e-5 relative, and 1e-5 of the output's scale absolute."""
    args = _din_inputs(b, t, d, h, cuda_device)
    before = din_attention.launches
    out = din_attention(*args)
    torch.cuda.synchronize()
    assert din_attention.launches == before + 1
    ref = din_attention_plain(*args)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * max(1.0, ref.abs().max().item()))
    assert not out[0].any()


@pytest.mark.cuda
def test_din_attention_kernel_takes_bf16_history(cuda_device):
    args = _din_inputs(64, 5, 10, 32, cuda_device)
    bf = [args[0].bfloat16(), args[1].bfloat16()] + args[2:]
    out = din_attention(*bf)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, din_attention_plain(*bf), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    with pytest.raises(ValueError, match="dtype"):
        fm_cross(torch.zeros(4, 5, 8, device=cuda_device, dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        fm_cross(torch.zeros(4, 8, 5, device=cuda_device).transpose(1, 2))
    args = _din_inputs(4, 5, 10, 24, cuda_device)
    with pytest.raises(ValueError, match="H in"):
        din_attention(*args)
    args = _din_inputs(4, 300, 10, 32, cuda_device)
    with pytest.raises(ValueError, match="steps"):
        din_attention(*args)
    args = _din_inputs(2, 5, 512, 64, cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        din_attention(*args)

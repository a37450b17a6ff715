"""FM second-order interaction: sum-square minus square-sum.

The port of `sparrowrecsys_tpu/ops/fm.py`. For stacked field embeddings
x [B, F, D] it computes (sum_f x)^2 - sum_f x^2 -> [B, D], with no 0.5
factor, as the reference. Its gradient is dx_f = 2 g (s - x_f), s = sum_f x.

- `fm_cross_plain`, `fm_cross_bwd_plain`: the plain PyTorch versions. They
  sum in float32 and return the input dtype, which is what the kernels do.
- `fm_cross`: a `torch.autograd.Function` whose residual is the raw input,
  as JAX's `_fm_pallas_fwd`. Forward and backward each take the plain
  version for a CPU tensor; for a CUDA tensor they launch the hand-written
  kernels of `csrc/fm_cross.cu` (the ports of `fm_cross_pallas` and of its
  VJP `fm_cross_bwd`), or raise.
- `fm_cross_bwd`: the backward's wrapper, callable on its own.
"""

from __future__ import annotations

import torch

from sparrowrecsys_torch.ops import kernels

_DTYPES = (torch.float32, torch.bfloat16)


def fm_cross_plain(fields: torch.Tensor) -> torch.Tensor:
    x = fields.float()
    s = x.sum(dim=1)
    sq = (x * x).sum(dim=1)
    return (s * s - sq).to(fields.dtype)


def fm_cross_bwd_plain(fields: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """[B, F, D] fields and [B, D] output gradient -> [B, F, D] in the
    fields' dtype; 2 g (s - x_f) in float32."""
    x = fields.float()
    s = x.sum(dim=1, keepdim=True)
    return (2.0 * g.float()[:, None, :] * (s - x)).to(fields.dtype)


def _check(name: str, fields: torch.Tensor, *others: torch.Tensor) -> int:
    """Raise on what the kernels do not take; returns the device index."""
    dev = kernels.require_cuda(name, fields, *others, dtypes=_DTYPES)
    if fields.dim() != 3:
        raise ValueError(f"{name}: expected [B, F, D], got {tuple(fields.shape)}")
    if any(t.dtype != fields.dtype for t in others):
        raise ValueError(f"{name}: the gradient must have the fields' dtype {fields.dtype}")
    return dev


_FWD = {torch.float32: kernels.TABLE["fm_cross"],
        torch.bfloat16: kernels.TABLE["fm_cross.bf16"]}
_BWD = {torch.float32: kernels.TABLE["fm_cross_bwd"],
        torch.bfloat16: kernels.TABLE["fm_cross_bwd.bf16"]}


def _fm_cross_kernel(fields: torch.Tensor) -> torch.Tensor:
    dev = _check("fm_cross", fields)
    b, f, d = fields.shape
    out = torch.empty((b, d), dtype=fields.dtype, device=fields.device)
    if out.numel() == 0:
        return out
    _FWD[fields.dtype](dev, fields.data_ptr(), out.data_ptr(), kernels.scalars(b, f, d, dev))
    return out


def fm_cross_bwd(fields: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dx [B, F, D] for the output gradient g [B, D]."""
    if fields.device.type == "cpu":
        return fm_cross_bwd_plain(fields, g)
    dev = _check("fm_cross_bwd", fields, g)
    b, f, d = fields.shape
    if tuple(g.shape) != (b, d):
        raise ValueError(f"fm_cross_bwd: g {tuple(g.shape)} != {(b, d)}")
    dx = torch.empty_like(fields)
    if dx.numel() == 0:
        return dx
    _BWD[fields.dtype](dev, fields.data_ptr(), g.data_ptr(), dx.data_ptr(),
                       kernels.scalars(b, f, d, dev))
    return dx


class _FMCross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fields):
        ctx.save_for_backward(fields)
        if fields.device.type == "cpu":
            return fm_cross_plain(fields)
        return _fm_cross_kernel(fields)

    @staticmethod
    def backward(ctx, g):
        (fields,) = ctx.saved_tensors
        return fm_cross_bwd(fields, g.contiguous())


def fm_cross(fields: torch.Tensor) -> torch.Tensor:
    """[B, F, D] float32 or bfloat16 -> [B, D] in the input dtype."""
    return _FMCross.apply(fields)

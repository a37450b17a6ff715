"""FM second-order interaction: sum-square minus square-sum.

The port of `sparrowrecsys_tpu/ops/fm.py`. For stacked field embeddings
x [B, F, D] it computes (sum_f x)^2 - sum_f x^2 -> [B, D], with no 0.5
factor, as the reference.

- `fm_cross_plain`: the plain PyTorch version. It sums in float32 and
  returns the input dtype, which is what the kernel does.
- `fm_cross`: the wrapper. A CPU tensor takes the plain version; a CUDA
  tensor launches the hand-written kernel `csrc/fm_cross.cu` (the port of
  the Pallas kernel `fm_cross_pallas`), or raises. CUDA C++ was chosen
  over Triton so that both of the slice's kernels share one build.

Forward only: the backward (`fm_cross_bwd` in the JAX package) comes
with the training slice.
"""

from __future__ import annotations

import torch

from sparrowrecsys_torch.ops import kernels


def fm_cross_plain(fields: torch.Tensor) -> torch.Tensor:
    x = fields.float()
    s = x.sum(dim=1)
    sq = (x * x).sum(dim=1)
    return (s * s - sq).to(fields.dtype)


def fm_cross(fields: torch.Tensor) -> torch.Tensor:
    """[B, F, D] float32 or bfloat16 -> [B, D] in the input dtype."""
    if fields.device.type == "cpu":
        return fm_cross_plain(fields)
    kernels.require_cuda("fm_cross", fields, dtypes=(torch.float32, torch.bfloat16))
    if fields.dim() != 3:
        raise ValueError(f"fm_cross: expected [B, F, D], got {tuple(fields.shape)}")
    b, f, d = fields.shape
    out = torch.empty((b, d), dtype=fields.dtype, device=fields.device)
    if out.numel() == 0:
        return out
    lib = kernels.library()
    fn = lib.fm_cross_f32 if fields.dtype == torch.float32 else lib.fm_cross_bf16
    err = fn(fields.data_ptr(), out.data_ptr(), b, f, d,
             fields.device.index or 0, kernels.stream_of(fields))
    kernels.check(lib, err, "fm_cross")
    fm_cross.launches += 1
    return out


#: Kernel launches since the last reset (a plain integer on the wrapper).
fm_cross.launches = 0

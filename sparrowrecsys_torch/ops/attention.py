"""DIN target attention (the activation unit), forward.

The port of `sparrowrecsys_tpu/ops/attention.py`. Given history
embeddings h [B, T, D] and a candidate embedding c [B, D]:
features [h, c, h*c] @ the folded weight [wa+wb; wc-wa; wd] (from
w1 [4D, H]) + b1 -> PReLU(alpha) -> @ w2 [H, 1] + b2 -> sigmoid -> 0 for
steps whose embedding row is all zero (`attention.py:48`, not "id != 0")
-> sum_t w_t * h_t, [B, D].

- `din_attention_plain`: the plain PyTorch version of `_unit`.
- `din_attention`: the wrapper. A CPU tensor takes the plain version; a
  CUDA tensor launches the hand-written kernel `csrc/din_attention.cu`
  (the port of the Pallas kernel `din_attention_pallas`), or raises.

Both take float32; bfloat16 history and candidate are cast up first, as
the JAX dispatch does for its kernel (`attention.py:157-159`), so the
result is float32. Forward only: the backward comes with the training
slice.
"""

from __future__ import annotations

import torch

from sparrowrecsys_torch.ops import kernels

#: Attention widths the kernel is instantiated for.
KERNEL_HIDDEN = (8, 16, 32, 64)
#: Most steps the kernel takes (one thread per step in a block).
KERNEL_MAX_STEPS = 256
#: Shared memory a block may use on the H100 (bytes).
MAX_SHARED_BYTES = 232_448


def _as_f32(hist, cand):
    if hist.dtype == torch.bfloat16:
        hist, cand = hist.float(), cand.float()
    return hist, cand


def din_attention_plain(hist, cand, w1, b1, alpha, w2, b2) -> torch.Tensor:
    hist, cand = _as_f32(hist, cand)
    d = hist.shape[-1]
    wa, wb, wc, wd = w1[:d], w1[d:2 * d], w1[2 * d:3 * d], w1[3 * d:]
    ce = cand.unsqueeze(-2).expand_as(hist)
    feats = torch.cat([hist, ce, hist * ce], dim=-1)            # [B, T, 3D]
    wk = torch.cat([wa + wb, wc - wa, wd], dim=0)               # [3D, H]
    a = feats @ wk + b1
    a = torch.where(a >= 0, a, alpha * a)
    w = torch.sigmoid(a @ w2 + b2)                               # [B, T, 1]
    w = w * (hist != 0).any(dim=-1, keepdim=True)
    return (w * hist).sum(dim=-2)


def shared_bytes(t: int, d: int, h: int) -> int:
    """Dynamic shared memory of one kernel block (see the .cu note)."""
    rows = 1 if t >= 128 else 128 // t
    return (3 * d * h + 3 * h + rows * t + rows * (h + 1)) * 4


def din_attention(hist, cand, w1, b1, alpha, w2, b2) -> torch.Tensor:
    """hist [B, T, D], cand [B, D], w1 [4D, H], b1 [H], alpha [H],
    w2 [H, 1], b2 [1] -> [B, D] float32."""
    if hist.device.type == "cpu":
        return din_attention_plain(hist, cand, w1, b1, alpha, w2, b2)
    hist, cand = _as_f32(hist, cand)
    kernels.require_cuda("din_attention", hist, cand, w1, b1, alpha, w2, b2)
    if hist.dim() != 3:
        raise ValueError(f"din_attention: hist must be [B, T, D], got {tuple(hist.shape)}")
    b, t, d = hist.shape
    h = w1.shape[-1]
    want = {"cand": (b, d), "w1": (4 * d, h), "b1": (h,), "alpha": (h,),
            "w2": (h, 1), "b2": (1,)}
    got = {"cand": cand, "w1": w1, "b1": b1, "alpha": alpha, "w2": w2, "b2": b2}
    for name, shape in want.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"din_attention: {name} {tuple(got[name].shape)} != {shape}")
    if h not in KERNEL_HIDDEN:
        raise ValueError(f"din_attention: kernel built for H in {KERNEL_HIDDEN}, got {h}")
    if not 1 <= t <= KERNEL_MAX_STEPS:
        raise ValueError(f"din_attention: kernel takes 1..{KERNEL_MAX_STEPS} steps, got {t}")
    if shared_bytes(t, d, h) > MAX_SHARED_BYTES:
        raise ValueError(
            f"din_attention: D={d}, H={h} needs {shared_bytes(t, d, h)} bytes of "
            f"shared memory, above the {MAX_SHARED_BYTES} a block may use"
        )
    out = torch.empty((b, d), dtype=torch.float32, device=hist.device)
    if out.numel() == 0:
        return out
    lib = kernels.library()
    err = lib.din_attention_f32(
        hist.data_ptr(), cand.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        alpha.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        b, t, d, h, hist.device.index or 0, kernels.stream_of(hist),
    )
    kernels.check(lib, err, "din_attention")
    din_attention.launches += 1
    return out


#: Kernel launches since the last reset (a plain integer on the wrapper).
din_attention.launches = 0

"""DIN target attention (the activation unit), forward and backward.

The port of `sparrowrecsys_tpu/ops/attention.py`. Given history
embeddings h [B, T, D] and a candidate embedding c [B, D]:
features [h, c, h*c] @ the folded weight [wa+wb; wc-wa; wd] (from
w1 [4D, H]) + b1 -> PReLU(alpha) -> @ w2 [H, 1] + b2 -> sigmoid -> 0 for
steps whose embedding row is all zero (`attention.py:48`, not "id != 0")
-> sum_t w_t * h_t, [B, D].

- `din_attention_plain`: the plain PyTorch version of `_unit`.
- `din_attention_bwd_plain`: the gradients of all seven inputs, written
  out by hand as the kernel computes them (recompute, then back through
  the folded weight and unfold), not through autograd.
- `din_attention`: a `torch.autograd.Function` whose residuals are the raw
  inputs, as JAX's `_din_fused_fwd`. Forward and backward each take the
  plain version for a CPU tensor; for a CUDA tensor they launch the
  hand-written kernels of `csrc/din_attention.cu` (the ports of
  `din_attention_pallas` and of its VJP `_din_fused_bwd`), or raise.
- `din_attention_bwd`: the backward's wrapper, callable on its own.

Both take float32; bfloat16 history and candidate are cast up first, as
the JAX dispatch does for its kernel (`attention.py:157-159`), so the
result is float32 (and the cast passes the gradient back in bf16).
"""

from __future__ import annotations

import ctypes

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


def _fold(w1: torch.Tensor, d: int) -> torch.Tensor:
    wa, wb, wc, wd = w1[:d], w1[d:2 * d], w1[2 * d:3 * d], w1[3 * d:]
    return torch.cat([wa + wb, wc - wa, wd], dim=0)               # [3D, H]


def din_attention_plain(hist, cand, w1, b1, alpha, w2, b2) -> torch.Tensor:
    hist, cand = _as_f32(hist, cand)
    d = hist.shape[-1]
    ce = cand.unsqueeze(-2).expand_as(hist)
    feats = torch.cat([hist, ce, hist * ce], dim=-1)            # [B, T, 3D]
    a = feats @ _fold(w1, d) + b1
    a = torch.where(a >= 0, a, alpha * a)
    w = torch.sigmoid(a @ w2 + b2)                               # [B, T, 1]
    w = w * (hist != 0).any(dim=-1, keepdim=True)
    return (w * hist).sum(dim=-2)


def din_attention_bwd_plain(hist, cand, w1, b1, alpha, w2, b2, g):
    """Gradients (dh [B,T,D], dc [B,D], dw1 [4D,H], db1 [H], dalpha [H],
    dw2 [H,1], db2 [1]) of `din_attention_plain` for the output gradient
    g [B, D], all float32."""
    hist, cand = _as_f32(hist, cand)
    g = g.float()
    d = hist.shape[-1]
    wk = _fold(w1, d)
    ce = cand.unsqueeze(-2).expand_as(hist)
    hc = hist * ce
    feats = torch.cat([hist, ce, hc], dim=-1)                    # [B, T, 3D]
    pre = feats @ wk + b1                                        # [B, T, H]
    neg = pre < 0                                                # PReLU: 0 takes the identity
    act = torch.where(neg, alpha * pre, pre)
    s = torch.sigmoid(act @ w2 + b2)[..., 0]                     # [B, T]
    mask = (hist != 0).any(dim=-1).to(s.dtype)                   # no gradient through it
    w = s * mask
    dw = (hist * g[:, None, :]).sum(-1)                          # d out / d w_t
    dl = dw * mask * s * (1 - s)                                 # d logit
    da = dl[..., None] * w2[:, 0]                                # [B, T, H]
    dpre = torch.where(neg, alpha * da, da)
    # The candidate's terms see the step only through dapre: they take
    # its sum over the row's steps, once per row.
    dsum = dpre.sum(1)                                           # [B, H]
    df0, df2 = dpre @ wk[:d].T, dpre @ wk[2 * d:].T              # [B, T, D] each
    dh = w[..., None] * g[:, None, :] + df0 + ce * df2
    dc = dsum @ wk[d:2 * d].T + (hist * df2).sum(1)
    flat = dpre.reshape(-1, dpre.shape[-1])
    dk0 = hist.reshape(-1, d).T @ flat
    dk1 = cand.T @ dsum
    dk2 = hc.reshape(-1, d).T @ flat
    dw1 = torch.cat([dk0 - dk1, dk0, dk1, dk2], dim=0)
    db1 = flat.sum(0)
    dalpha = torch.where(neg, pre * da, torch.zeros_like(da)).reshape(flat.shape).sum(0)
    dw2 = (act * dl[..., None]).reshape(flat.shape).sum(0)[:, None]
    db2 = dl.sum().reshape(1)
    return dh, dc, dw1, db1, dalpha, dw2, db2


def shared_bytes(t: int, d: int, h: int) -> int:
    """Dynamic shared memory of one forward kernel block (see the .cu note)."""
    rows = 1 if t >= 128 else 128 // t
    return (3 * d * h + 3 * h + rows * t + rows * (h + 1)) * 4


def bwd_shared_bytes(t: int, d: int, h: int) -> int:
    """Dynamic shared memory of one backward kernel block (`bwd_shared_floats`)."""
    rows = 1 if t >= 128 else 128 // t
    n = rows * t
    return (3 * d * h + n * h + rows * h + 3 * h + grad_elems(d, h) + rows * (h + 1)
            + n * (h + 1) + n + n * (d | 1)) * 4


def grad_elems(d: int, h: int) -> int:
    """Weight-gradient elements one backward block sums: [dk0|dk1|dk2],
    db1, dalpha, dw2, db2."""
    return 3 * d * h + 3 * h + 1


def _check(name, hist, cand, w1, b1, alpha, w2, b2, *more, smem=shared_bytes):
    """Raise on what the kernels do not take; returns (device index, B, T, D, H)."""
    dev = kernels.require_cuda(name, hist, cand, w1, b1, alpha, w2, b2, *more)
    if hist.dim() != 3:
        raise ValueError(f"{name}: hist must be [B, T, D], got {tuple(hist.shape)}")
    b, t, d = hist.shape
    h = w1.shape[-1]
    want = {"cand": (b, d), "w1": (4 * d, h), "b1": (h,), "alpha": (h,),
            "w2": (h, 1), "b2": (1,)}
    got = {"cand": cand, "w1": w1, "b1": b1, "alpha": alpha, "w2": w2, "b2": b2}
    if more:
        want["g"], got["g"] = (b, d), more[0]
    for key, shape in want.items():
        if tuple(got[key].shape) != shape:
            raise ValueError(f"{name}: {key} {tuple(got[key].shape)} != {shape}")
    if h not in KERNEL_HIDDEN:
        raise ValueError(f"{name}: kernel built for H in {KERNEL_HIDDEN}, got {h}")
    if not 1 <= t <= KERNEL_MAX_STEPS:
        raise ValueError(f"{name}: kernel takes 1..{KERNEL_MAX_STEPS} steps, got {t}")
    if smem(t, d, h) > MAX_SHARED_BYTES:
        raise ValueError(
            f"{name}: D={d}, H={h} needs {smem(t, d, h)} bytes of "
            f"shared memory, above the {MAX_SHARED_BYTES} a block may use"
        )
    return dev, b, t, d, h


def _din_attention_kernel(hist, cand, w1, b1, alpha, w2, b2) -> torch.Tensor:
    dev, b, t, d, h = _check("din_attention", hist, cand, w1, b1, alpha, w2, b2)
    out = torch.empty((b, d), dtype=torch.float32, device=hist.device)
    if out.numel() == 0:
        return out
    lib = kernels.library()
    err = lib.din_attention_f32(
        hist.data_ptr(), cand.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        alpha.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
        b, t, d, h, dev, kernels.stream_of(dev),
    )
    kernels.check(lib, err, "din_attention")
    din_attention.launches += 1
    return out


def din_attention_bwd(hist, cand, w1, b1, alpha, w2, b2, g):
    """The seven input gradients of `din_attention` for the output
    gradient g [B, D]; float32 history and candidate."""
    if hist.device.type == "cpu":
        return din_attention_bwd_plain(hist, cand, w1, b1, alpha, w2, b2, g)
    dev, b, t, d, h = _check("din_attention_bwd", hist, cand, w1, b1, alpha, w2, b2, g,
                             smem=bwd_shared_bytes)
    dh = torch.empty_like(hist)
    dc = torch.empty_like(cand)
    dw1, db1, dalpha = torch.empty_like(w1), torch.empty_like(b1), torch.empty_like(alpha)
    dw2, db2 = torch.empty_like(w2), torch.empty_like(b2)
    if b == 0:
        for z in (dw1, db1, dalpha, dw2, db2):
            z.zero_()
        return dh, dc, dw1, db1, dalpha, dw2, db2
    lib = kernels.library()
    grid = ctypes.c_int64(0)
    err = lib.din_attention_bwd_grid(hist.data_ptr(), cand.data_ptr(), g.data_ptr(),
                                     b, t, d, h, dev, ctypes.addressof(grid))
    kernels.check(lib, err, "din_attention_bwd")
    scratch = torch.empty((grid.value, grad_elems(d, h)), dtype=torch.float32,
                          device=hist.device)
    err = lib.din_attention_bwd_f32(
        hist.data_ptr(), cand.data_ptr(), w1.data_ptr(), b1.data_ptr(), alpha.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), g.data_ptr(), dh.data_ptr(), dc.data_ptr(),
        scratch.data_ptr(), grid.value, dw1.data_ptr(), db1.data_ptr(), dalpha.data_ptr(),
        dw2.data_ptr(), db2.data_ptr(), b, t, d, h, dev, kernels.stream_of(dev),
    )
    kernels.check(lib, err, "din_attention_bwd")
    din_attention_bwd.launches += 1
    return dh, dc, dw1, db1, dalpha, dw2, db2


class _DINAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hist, cand, w1, b1, alpha, w2, b2):
        ctx.save_for_backward(hist, cand, w1, b1, alpha, w2, b2)
        if hist.device.type == "cpu":
            return din_attention_plain(hist, cand, w1, b1, alpha, w2, b2)
        return _din_attention_kernel(hist, cand, w1, b1, alpha, w2, b2)

    @staticmethod
    def backward(ctx, g):
        return din_attention_bwd(*ctx.saved_tensors, g.contiguous())


def din_attention(hist, cand, w1, b1, alpha, w2, b2) -> torch.Tensor:
    """hist [B, T, D], cand [B, D], w1 [4D, H], b1 [H], alpha [H],
    w2 [H, 1], b2 [1] -> [B, D] float32."""
    hist, cand = _as_f32(hist, cand)
    return _DINAttention.apply(hist, cand, w1, b1, alpha, w2, b2)


#: Kernel launches since the last reset (plain integers on the wrappers).
din_attention.launches = 0
din_attention_bwd.launches = 0

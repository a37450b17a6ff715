"""DIN target attention (the activation unit), forward and backward.

The port of `sparrowrecsys_tpu/ops/attention.py`. Given history
embeddings h [B, T, D] and a candidate embedding c [B, D]:
features [h, c, h*c] @ the folded weight [wa+wb; wc-wa; wd] (from
w1 [4D, H]) + b1 -> PReLU(alpha) -> @ w2 [H, 1] + b2 -> sigmoid -> 0 for
steps whose embedding row is all zero (`attention.py:48`, not "id != 0")
-> sum_t w_t * h_t, [B, D].

- `din_attention_plain`: the plain PyTorch version of `_unit`.
- `din_attention_bwd_steps_plain`: the plain version of the per-step
  backward kernel: dh, dc, dapre, the product operands hx = [h, h*c] and
  dsum = sum_t dapre_t, and the small weight gradients.
- `din_attention_bwd_plain`: the gradients of all seven inputs, written
  out by hand (recompute, then back through the folded weight and
  unfold), not through autograd: the reference for the backward.
- `din_attention`: a `torch.autograd.Function` whose residuals are the raw
  inputs, as JAX's `_din_fused_fwd`. Forward and backward each take the
  plain version for a CPU tensor; for a CUDA tensor they launch the
  hand-written kernels of `csrc/din_attention.cu` (the ports of
  `din_attention_pallas` and of the per-step part of its VJP
  `_din_fused_bwd`), or raise.
- `din_attention_bwd`: the backward's wrapper, callable on its own. The
  kernel (or, on the CPU, its plain version) writes the per-step terms;
  the three [D, H] weight gradients are matrix products on them
  (`_din_weight_grads`), as XLA computes them for `jax.vjp(_unit)`.

The kernels take every (B, T, D, H): `plan` picks how (chunks of H,
rows per block, what sits in shared memory). Both take float32; bfloat16
history and candidate are cast up first, as the JAX dispatch does for
its kernel (`attention.py:157-159`), so the result is float32 (and the
cast passes the gradient back in bf16).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from sparrowrecsys_torch.ops import kernels

#: Chunk widths of H the kernels are instantiated for (`HC` in the .cu).
KERNEL_CHUNKS = (8, 16, 32, 64)
#: Steps a block aims to hold (whole rows), and the most threads it runs.
ROW_THREADS = 128
MAX_THREADS = 256
#: A block's shared-memory budgets, in bytes: the folded weight of one
#: chunk (else it is read through L1), the staged tile (else read from
#: global memory) and the forward's step weights (else a scratch). At
#: most about 215 KB in all, under the H100's 227 KB.
WEIGHT_BYTES = 80 * 1024
STAGE_BYTES = 32 * 1024
STEP_WEIGHT_BYTES = 32 * 1024
#: The weight-gradient products' long dimension (B*T for hx^T dapre, B
#: for c^T dsum) is cut into this many slices, multiplied as one batched
#: product and summed in slice order: faster on the H100 at the training
#: shape than one `torch.mm` each, whose split of that dimension is
#: cuBLAS's (`chip_smoke.py` times both).
PRODUCT_SLICES = 512


class Plan(NamedTuple):
    """How the kernels cover one (T, D, H): H in `chunks` chunks of `hc`
    columns (the last padded with zero weights), `rows` batch rows per
    block of `threads`. The kernels stage the rows' history, candidates
    and (backward) output gradients in shared memory (`staged`); the
    folded weight is read through L1 from a [3D, chunks * hc] copy the
    wrapper makes (`weights_global`); the forward's step weights go to a
    [B*T] scratch (`step_weights_global`)."""

    hc: int
    chunks: int
    rows: int
    threads: int
    staged: bool
    weights_global: bool
    step_weights_global: bool


@functools.lru_cache(maxsize=1024)
def plan(t: int, d: int, h: int) -> Plan:
    """The kernels' plan for T >= 1 steps of width D >= 1 and H >= 0: the
    narrowest chunk that covers H (64 above it), halved while its folded
    weight [3D, hc + 4] (rows padded for the banks) passes
    `WEIGHT_BYTES`; whole rows of up to `ROW_THREADS` steps a block (one
    row of a longer history); the tile staged where its T + 2 rows of D|1
    words a batch row, and the backward's row of D|1 words a thread, fit
    `STAGE_BYTES`."""
    hc = next((w for w in KERNEL_CHUNKS if w >= h), KERNEL_CHUNKS[-1])
    while hc > KERNEL_CHUNKS[0] and 3 * d * (hc + 4) * 4 > WEIGHT_BYTES:
        hc //= 2
    weights_global = 3 * d * (hc + 4) * 4 > WEIGHT_BYTES
    rows = max(1, ROW_THREADS // t)
    threads = min(MAX_THREADS, -(-rows * t // 32) * 32)
    staged = not weights_global and (rows * (t + 2) + threads) * (d | 1) * 4 <= STAGE_BYTES
    return Plan(hc, max(1, -(-h // hc)), rows, threads, staged, weights_global,
                rows * t * 4 > STEP_WEIGHT_BYTES)


@functools.lru_cache(maxsize=1024)
def _scalars(b: int, t: int, d: int, h: int, dev: int):
    """The entry points' int64 scalars for one launch shape (`enum Scalar`
    in the .cu): B, T, D, H, the plan, device. Cached on the shape, which
    a trainer or a server repeats call after call."""
    p = plan(t, d, h)
    return (ctypes.c_int64 * 12)(b, t, d, h, p.hc, p.chunks, p.rows, p.threads, p.staged,
                                 p.weights_global, p.step_weights_global, dev)


def _as_f32(hist, cand):
    if hist.dtype == torch.bfloat16:
        hist, cand = hist.float(), cand.float()
    return hist, cand


def _fold(w1: torch.Tensor, d: int) -> torch.Tensor:
    wa, wb, wc, wd = w1[:d], w1[d:2 * d], w1[2 * d:3 * d], w1[3 * d:]
    return torch.cat([wa + wb, wc - wa, wd], dim=0)               # [3D, H]


def _folded(w1: torch.Tensor, d: int, p: Plan) -> torch.Tensor:
    """The folded weight padded to the plan's chunks, [3D, chunks * hc]."""
    wk = _fold(w1, d)
    return torch.nn.functional.pad(wk, (0, p.chunks * p.hc - wk.shape[1])).contiguous()


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


def din_attention_bwd_steps_plain(hist, cand, w1, b1, alpha, w2, b2, g):
    """What the per-step backward kernel writes, for the output gradient
    g [B, D]: dh [B,T,D], dc [B,D], dapre [B*T,H] (the pre-activations'
    gradient), hx = [h, h*c] [B*T,2D], dsum = sum_t dapre_t [B,H] and
    [db1 | dalpha | dw2 | db2] (3H+1), all float32."""
    hist, cand = _as_f32(hist, cand)
    g = g.float()
    b, t, d = hist.shape
    wk = _fold(w1, d)
    ce = cand.unsqueeze(-2).expand_as(hist)
    hc = hist * ce
    pre = torch.cat([hist, ce, hc], dim=-1) @ wk + b1            # [B, T, H]
    neg = pre < 0                                                # PReLU: 0 takes the identity
    act = torch.where(neg, alpha * pre, pre)
    s = torch.sigmoid(act @ w2 + b2)[..., 0]                     # [B, T]
    mask = (hist != 0).any(dim=-1).to(s.dtype)                   # no gradient through it
    dl = (hist * g[:, None, :]).sum(-1) * mask * s * (1 - s)     # d logit
    da = dl[..., None] * w2[:, 0]                                # [B, T, H]
    dpre = torch.where(neg, alpha * da, da)
    # The candidate's terms see the step only through dapre: they take
    # its sum over the row's steps, once per row.
    dsum = dpre.sum(1)                                           # [B, H]
    df2 = dpre @ wk[2 * d:].T                                    # [B, T, D]
    dh = (s * mask)[..., None] * g[:, None, :] + dpre @ wk[:d].T + ce * df2
    dc = dsum @ wk[d:2 * d].T + (hist * df2).sum(1)
    small = torch.cat([dpre.sum((0, 1)), torch.where(neg, pre * da, 0.0).sum((0, 1)),
                       (act * dl[..., None]).sum((0, 1)), dl.sum().reshape(1)])
    hx = torch.cat([hist, hc], dim=-1).reshape(b * t, 2 * d)
    return dh, dc, dpre.reshape(b * t, -1), hx, dsum, small


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


def _tn(a, b) -> torch.Tensor:
    """a^T b for a [n, p] and b [n, q]: one batched product over
    `PRODUCT_SLICES` slices of the rows, summed in slice order, plus one
    product on the rows past the last whole slice."""
    n = a.shape[0]
    rows = n // PRODUCT_SLICES
    if rows == 0:
        return a.T @ b
    cut = rows * PRODUCT_SLICES
    out = torch.bmm(a[:cut].reshape(PRODUCT_SLICES, rows, -1).transpose(1, 2),
                    b[:cut].reshape(PRODUCT_SLICES, rows, -1)).sum(0)
    return out if cut == n else out + a[cut:].T @ b[cut:]


def _din_weight_grads(hx, dapre, cand, dsum) -> torch.Tensor:
    """dw1 [4D, H] from the per-step terms: hx = [h, h*c] [B*T, 2D],
    dapre [B*T, H], cand [B, D] and dsum = sum_t dapre_t [B, H]. The
    gradient of the folded weight [wa+wb; wc-wa; wd] is [dk0; dk1; dk2]
    with [dk0; dk2] = hx^T dapre and dk1 = c^T dsum (`_tn` each), unfolded
    to dwa = dk0 - dk1, dwb = dk0, dwc = dk1, dwd = dk2. One product on
    [h, h*c] reads dapre once: at the training shape (D < H) that is
    faster on the H100 than h^T dapre and (h*c)^T dapre, for all that the
    kernel writes a copy of h (`chip_smoke.py` times both). They follow
    PyTorch's float32 matmul precision, like every other matmul of the
    model: full float32 unless the caller allows TF32
    (`torch.backends.cuda.matmul.allow_tf32`)."""
    d = hx.shape[1] // 2
    dk02 = _tn(hx, dapre)
    dk1 = _tn(cand, dsum)
    dk0 = dk02[:d]
    return torch.cat([dk0 - dk1, dk0, dk1, dk02[d:]], dim=0)


def _check(name, hist, cand, w1, b1, alpha, w2, b2, *more):
    """Raise on what the kernels do not take (another dtype or device, a
    non-contiguous tensor, mismatched shapes); returns (device index, B,
    T, D, H)."""
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
    return dev, b, t, d, h


def _ptr(x) -> int | None:
    return None if x is None else x.data_ptr()


def _din_attention_kernel(hist, cand, w1, b1, alpha, w2, b2) -> torch.Tensor:
    dev, b, t, d, h = _check("din_attention", hist, cand, w1, b1, alpha, w2, b2)
    if b * t * d == 0:
        return hist.new_zeros((b, d))
    out = hist.new_empty((b, d))
    p = plan(t, d, h)
    wfold = _folded(w1, d, p) if p.weights_global else None
    wt = hist.new_empty(b * t) if p.step_weights_global else None
    lib = kernels.library()
    err = lib.din_attention_f32(
        hist.data_ptr(), cand.data_ptr(), w1.data_ptr(), b1.data_ptr(), alpha.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), _ptr(wfold), out.data_ptr(), _ptr(wt),
        _scalars(b, t, d, h, dev), kernels.stream_of(dev),
    )
    if err:
        kernels.check(lib, err, "din_attention")
    din_attention.launches += 1
    return out


#: The backward's grid per (B, T, D, H, device, 16-byte path): the C side
#: sizes it from the kernel's occupancy, and the wrapper sizes the
#: [grid * warps, 3H+1] scratch (a row per warp) by it.
_bwd_grids: dict = {}


def _din_attention_bwd_steps(hist, cand, w1, b1, alpha, w2, b2, g):
    """The per-step backward kernel's outputs (`din_attention_bwd_steps_plain`)."""
    dev, b, t, d, h = _check("din_attention_bwd", hist, cand, w1, b1, alpha, w2, b2, g)
    if b * t * d == 0:
        z = hist.new_zeros
        return (z(hist.shape), z(cand.shape), z((b * t, h)), z((b * t, 2 * d)), z((b, h)),
                z(3 * h + 1))
    p = plan(t, d, h)
    wfold = _folded(w1, d, p) if p.weights_global else None
    scalars = _scalars(b, t, d, h, dev)
    ptrs = (hist.data_ptr(), cand.data_ptr(), g.data_ptr())
    lib = kernels.library()
    key = (b, t, d, h, dev, (ptrs[0] | ptrs[1] | ptrs[2]) & 15 == 0)
    grid = _bwd_grids.get(key)
    if grid is None:
        got = ctypes.c_int64(0)
        err = lib.din_attention_bwd_grid(*ptrs, _ptr(wfold), scalars, ctypes.addressof(got))
        kernels.check(lib, err, "din_attention_bwd")
        grid = _bwd_grids[key] = got.value
    new = hist.new_empty
    dh, dc, dsum, small = new(hist.shape), new(cand.shape), new((b, h)), new(3 * h + 1)
    dapre, hx = new((b * t, h)), new((b * t, 2 * d))
    partial = new((grid * (p.threads // 32), 3 * h + 1))
    err = lib.din_attention_bwd_f32(
        ptrs[0], ptrs[1], w1.data_ptr(), b1.data_ptr(), alpha.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), _ptr(wfold), ptrs[2], dh.data_ptr(), dc.data_ptr(), dapre.data_ptr(),
        hx.data_ptr(), dsum.data_ptr(), partial.data_ptr(), small.data_ptr(), scalars, grid,
        kernels.stream_of(dev),
    )
    if err:
        kernels.check(lib, err, "din_attention_bwd")
    din_attention_bwd.launches += 1
    return dh, dc, dapre, hx, dsum, small


def din_attention_bwd(hist, cand, w1, b1, alpha, w2, b2, g):
    """The seven input gradients of `din_attention` for the output
    gradient g [B, D]: the per-step terms from the kernel (the plain
    version for a CPU tensor), dw1 from `_din_weight_grads`."""
    hist, cand = _as_f32(hist, cand)
    steps = din_attention_bwd_steps_plain if hist.device.type == "cpu" else _din_attention_bwd_steps
    dh, dc, dapre, hx, dsum, small = steps(hist, cand, w1, b1, alpha, w2, b2, g)
    h = dapre.shape[-1]
    dw1 = _din_weight_grads(hx, dapre, cand, dsum)
    return dh, dc, dw1, small[:h], small[h:2 * h], small[2 * h:3 * h, None], small[3 * h:]


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

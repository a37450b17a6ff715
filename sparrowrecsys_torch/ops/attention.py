"""DIN target attention (the activation unit), forward and backward.

The port of `sparrowrecsys_tpu/ops/attention.py`. Given history
embeddings h [B, T, D] and a candidate embedding c [B, D]:
features [h, c, h*c] @ the folded weight [wa+wb; wc-wa; wd] (from
w1 [4D, H]) + b1 -> PReLU(alpha) -> @ w2 [H, 1] + b2 -> sigmoid -> 0 for
steps whose embedding row is all zero (`attention.py:48`, not "id != 0")
-> sum_t w_t * h_t, [B, D].

- `din_attention_plain`: the plain PyTorch version of `_unit`.
- `din_attention_bwd_steps_plain`: the plain version of the per-step
  backward kernel: dh, dc, dapre, the product operands hx = [h, h*c]
  (h*c alone where D > H) and dsum = sum_t dapre_t, and the small weight
  gradients.
- `tf32_split_product_plain`: the kernels' tensor-core product in plain
  PyTorch, each operand split into two TF32 parts and three products
  summed in float32.
- `din_attention_bwd_plain`: the gradients of all seven inputs, written
  out by hand (recompute, then back through the folded weight and
  unfold), not through autograd: the reference for the backward.
- `din_attention_bwd_narrow_plain`: the plain version of the narrow
  backward (`csrc/din_narrow.cu`): the candidate folded into the weight
  per row, R_b = sum_t h_t^T dapre_t per row, and the weight gradients
  summed per unit of `unit_rows` rows, then over the units in the
  reduce's fixed order.
- `din_attention`: a `torch.autograd.Function` whose residuals are the raw
  inputs, as JAX's `_din_fused_fwd`. Forward and backward each take the
  plain version for a CPU tensor; for a CUDA tensor they launch
  hand-written kernels (the ports of `din_attention_pallas` and of its
  VJP `_din_fused_bwd`), or raise. `narrow(D, H)` picks which, from the
  shapes alone: D <= 16 and H <= 32 take `csrc/din_narrow.cu` (float32
  FFMA on the CUDA cores, the weight gradients summed inside the
  backward), every other shape `csrc/din_attention.cu` (the tensor
  cores).
- `din_attention_bwd`: the backward's wrapper, callable on its own. On
  the narrow path the kernel writes all seven gradients. Otherwise the
  kernel (or, on the CPU, its plain version) writes the per-step terms
  and the three [D, H] weight gradients are matrix products on them
  (`_din_weight_grads`), as XLA computes them for `jax.vjp(_unit)`.

The tensor-core kernels take every (B, T, D, H): `plan` picks how (steps
a chunk, tiles of H, slices of D, whether the weights stay in shared
memory). All take float32; bfloat16
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

#: A block's shared memory on the H100 (227 KB), in bytes.
SHARED_BYTES = 232_448
#: Warps a block may run, each owning 16 steps of a chunk: M = 16 * warps.
WARPS = (8, 4, 2, 1)
#: Histories of at most this many steps take the candidate's term
#: c @ (wc-wa) into the tile's product, as a third segment of K, per step;
#: longer ones compute it once per batch row (T times fewer operations).
CT_STEPS = 8
#: The weight-gradient products' long dimension (B*T for hx^T dapre, B
#: for c^T dsum) is cut into this many slices, multiplied as one batched
#: product and summed in slice order: faster on the H100 at the training
#: shape than one `torch.mm` each, whose split of that dimension is
#: cuBLAS's (`chip_smoke.py` times both).
PRODUCT_SLICES = 512
#: The narrow kernels' widths (`csrc/din_narrow.cu`): D <= NARROW_D and
#: H <= NARROW_H, H padded to a warp's 32 lanes.
NARROW_D, NARROW_H = 16, 32
#: The narrow backward sums its weight gradients per unit of whole rows:
#: at most UNIT_STEPS steps a unit (one row where T is longer), and rows
#: few enough that a batch makes about UNITS units to spread over the card.
UNIT_STEPS, UNITS = 4096, 2048


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, on the bits, as `cvt.rna.tf32.f32` rounds: the low 13 bits
    are rounded into bit 13 and cleared. Infinities and NaNs pass."""
    bits = x.contiguous().view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


def tf32_split_product_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] as the kernels' tensor-core tiles compute it in
    float32: each operand x split into hi = tf32(x) and lo = tf32(x - hi),
    and the three products lo·hi + hi·lo + hi·hi (each exact in float32,
    as a TF32 product is) summed in float32. lo·lo, below float32's last
    bit, is dropped."""
    a, b = a.float(), b.float()
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


class Plan(NamedTuple):
    """How a kernel covers one (T, D, H). A chunk is M = 16 * `warps`
    steps of `rows` whole batch rows (T <= M), or M steps of one row;
    each warp takes 16 of them through the products. H runs in `chunks`
    chunks of `nt` tiles of 8 columns (zero weights past H); D in slices
    of `slice_steps` * 8 columns, `slices` of them. The split weights of
    a slice sit in shared memory (for the whole launch where D is one
    slice, else loaded per slice); `wc_shared`: wc - wa too, for the
    candidate's terms; `ct`: the candidate's term in the product instead
    (`CT_STEPS`). `shared_bytes`: the block's shared memory, as the .cu
    lays it out (`shared_floats`)."""

    warps: int
    rows: int
    nt: int
    chunks: int
    slice_steps: int
    slices: int
    wc_shared: bool
    ct: bool
    shared_bytes: int


def _odd4(w: int) -> int:
    """The staged row stride for rows of w floats: a multiple of 4 whose
    quarter is odd, so the 8 rows a fragment reads fall in distinct bank
    groups."""
    s = -(-w // 4) * 4
    return s if (s // 4) % 2 else s + 4


def _r4(x: int) -> int:
    return -(-x // 4) * 4


def _n_tiles(h: int):
    """(nt, chunks, np): tiles of 8 columns a chunk, chunks, padded H."""
    n8 = max(1, -(-h // 8))
    nt = min(8, 1 << (n8 - 1).bit_length())
    chunks = -(-n8 // nt)
    return nt, chunks, chunks * nt * 8


def shared_floats(t: int, d: int, h: int, warps: int, slice_steps: int, wc_shared: bool,
                  backward: bool, ct: bool = False) -> int:
    """A block's shared memory in floats, region by region as
    `make_dims` in csrc/din_attention.cu lays it out: the weight slab
    (the slice's k-steps of [wa+wb; wd], and of wc - wa where `ct`, as B
    fragments, 16 bytes a lane a tile: hi and lo of two values; the
    backward reads its transposed operand from the same slab), alpha, w2
    and b1, wc - wa [D, np + 8] where `wc_shared`, the candidate term
    [rows, np] unless `ct`, the backward's dsum
    [rows, np], the step weights [M], the pre-activations [M, ps]
    (backward; forward over several slices), the backward's per-warp
    small sums, and two ring slots of the staged history [M, hs],
    candidates and (backward) output gradients [rows, hs]."""
    m = 16 * warps
    rows = max(1, m // t)
    nt, chunks, np_ = _n_tiles(h)
    kst = -(-d // 8)
    slices = -(-kst // slice_steps)
    hs = _odd4(min(d, 8 * slice_steps))
    ps = np_ if (np_ // 8) % 2 else np_ + 8
    floats = (3 if ct else 2) * slice_steps * chunks * nt * 128 + _r4(3 * np_) + _r4(m)
    if not ct:
        floats += _r4(rows * np_)
    if wc_shared:
        floats += _r4(d * (np_ + 8))
    if backward or slices > 1:
        floats += _r4(m * ps)
    if backward:
        floats += _r4(rows * np_) + _r4(warps * (3 * np_ + 1))
    return floats + 2 * (_r4(m * hs + 4) + _r4(rows * hs + 4) * (2 if backward else 1))


@functools.lru_cache(maxsize=2048)
def plan(t: int, d: int, h: int, backward: bool = False) -> Plan:
    """The forward's (or the backward's) plan for T >= 1 steps of width
    D >= 1 and H >= 0: D in as few slices as fit (one: the weights stay in
    shared memory for the launch), wc - wa in shared memory where it fits
    (the candidate's terms read it row after row), then the most warps.
    Up to `CT_STEPS` steps in one slice, the candidate's term goes into the
    product instead, where that fits as many warps."""
    nt, chunks, _ = _n_tiles(h)
    kst = -(-d // 8)
    widths, s = [kst], kst
    while s > 1:
        s = -(-s // 2)
        widths.append(s)

    def make(warps, sks, wc, ct):
        f = 4 * shared_floats(t, d, h, warps, sks, wc, backward, ct)
        if f <= SHARED_BYTES:
            return Plan(warps, max(1, 16 * warps // t), nt, chunks, sks, -(-kst // sks), wc, ct, f)
        return None

    for sks in widths:
        for wc in ((True, False) if sks == kst else (False,)):
            best = next(filter(None, (make(w, sks, wc, False) for w in WARPS)), None)
            if best is not None:
                if t <= CT_STEPS and best.slices == 1:
                    return make(best.warps, sks, False, True) or best
                return best
    raise ValueError(f"din_attention: no launch plan fits T={t}, D={d}, H={h}")


def _tc_scalars(b: int, t: int, d: int, h: int, dev: int, backward: bool = False):
    """The tensor-core entry points' int64 scalars (`enum Scalar` in the
    .cu): B, T, D, H, the plan, device."""
    p = plan(t, d, h, backward)
    return kernels.scalars(b, t, d, h, p.warps, p.rows, p.nt, p.chunks, p.slice_steps,
                           p.wc_shared, p.ct, p.shared_bytes, dev)


def narrow(d: int, h: int) -> bool:
    """Whether a unit of width D and H takes the narrow kernels
    (`csrc/din_narrow.cu`) rather than the tensor cores'."""
    return d <= NARROW_D and h <= NARROW_H


@functools.lru_cache(maxsize=1024)
def unit_rows(b: int, t: int) -> int:
    """Rows a unit of the narrow backward, from B and T alone (so the
    order of every sum is fixed by the shape, whatever the grid)."""
    return max(1, min(-(-UNIT_STEPS // t), -(-b // UNITS)))


def narrow_partial_width(d: int) -> int:
    """Floats of a unit's partial: [dk0 | db1], [dk1 | dalpha],
    [dk2 | dw2], each [D + 1, 32], then db2, padded to 32."""
    return 3 * (d + 1) * 32 + 32


def hx_alone(d: int, h: int) -> bool:
    """Whether the backward writes h*c alone [B*T, D] (D > H: the weight
    products take dk0 from the history itself) rather than
    hx = [h, h*c] [B*T, 2D] (one product reads dapre once)."""
    return d > h


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


def din_attention_bwd_steps_plain(hist, cand, w1, b1, alpha, w2, b2, g):
    """What the per-step backward kernel writes, for the output gradient
    g [B, D]: dh [B,T,D], dc [B,D], dapre [B*T,H] (the pre-activations'
    gradient), hx = [h, h*c] [B*T,2D] (h*c alone [B*T,D] where
    `hx_alone`), dsum = sum_t dapre_t [B,H] and [db1 | dalpha | dw2 | db2]
    (3H+1), all float32."""
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
    h = w1.shape[-1]
    hx = hc if hx_alone(d, h) else torch.cat([hist, hc], dim=-1)
    return dh, dc, dpre.reshape(b * t, -1), hx.reshape(b * t, -1), dsum, small


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


def din_attention_bwd_narrow_plain(hist, cand, w1, b1, alpha, w2, b2, g, rows=None):
    """The seven gradients of `din_attention_bwd_plain`, computed as the
    narrow kernel computes them: the candidate folded into the weight per
    row (W_c = (wa+wb) + diag(c) wd, u_c = b1 + c (wc-wa)), dh through
    W_c, R_b = sum_t h_t^T dapre_t per row, dc from dsum and R_b, the
    weight gradients summed per unit of `rows` rows (`unit_rows` by
    default), and the units' partials summed as the reduce sums them: 32
    interleaved runs in unit order, then the runs in order."""
    hist, cand = _as_f32(hist, cand)
    g = g.float()
    b, t, d = hist.shape
    h = w1.shape[-1]
    wa, wb, wc, wd = w1[:d], w1[d:2 * d], w1[2 * d:3 * d], w1[3 * d:]
    wab, wcma = wa + wb, wc - wa
    fold = wab + cand[:, :, None] * wd                           # [B, D, H]
    u = b1 + cand @ wcma                                         # [B, H]
    pre = hist @ fold + u[:, None, :]                            # [B, T, H]
    neg = pre < 0                                                # PReLU: 0 takes the identity
    act = torch.where(neg, alpha * pre, pre)
    s = torch.sigmoid(act @ w2 + b2)[..., 0]                     # [B, T]
    mask = (hist != 0).any(dim=-1).to(s.dtype)
    dl = (hist * g[:, None, :]).sum(-1) * mask * s * (1 - s)     # d logit
    da = dl[..., None] * w2[:, 0]
    dpre = torch.where(neg, alpha * da, da)                      # [B, T, H]
    dh = (s * mask)[..., None] * g[:, None, :] + dpre @ fold.transpose(1, 2)
    dsum = dpre.sum(1)                                           # [B, H]
    r = hist.transpose(1, 2) @ dpre                              # R_b [B, D, H]
    dc = dsum @ wcma.T + (wd * r).sum(-1)
    # A row's share of each partial: [dk0 | db1], [dk1 | dalpha], [dk2 | dw2], db2.
    dalpha = torch.where(neg, pre * da, 0.0).sum(1)              # [B, H]
    dw2 = (act * dl[..., None]).sum(1)
    per_row = torch.cat([
        torch.cat([r, dsum[:, None]], 1),
        torch.cat([cand[:, :, None] * dsum[:, None], dalpha[:, None]], 1),
        torch.cat([cand[:, :, None] * r, dw2[:, None]], 1),
    ], 1).reshape(b, -1)
    per_row = torch.cat([per_row, dl.sum(1)[:, None]], 1)
    rows = rows or unit_rows(b, t)
    units = -(-b // rows)
    runs = -(-units // 32) * 32
    per_row = torch.nn.functional.pad(per_row, (0, 0, 0, runs * rows - b))
    partial = per_row.reshape(runs, rows, -1).sum(1).reshape(runs // 32, 32, -1)
    acc = partial[0]
    for i in range(1, runs // 32):
        acc = acc + partial[i]                                   # each run in unit order
    total = acc[0]
    for i in range(1, 32):
        total = total + acc[i]                                   # then the runs in order
    planes, db2 = total[:-1].reshape(3, d + 1, h), total[-1:]
    dk0, dk1, dk2 = planes[0, :d], planes[1, :d], planes[2, :d]
    dw1 = torch.cat([dk0 - dk1, dk0, dk1, dk2], dim=0)
    return dh, dc, dw1, planes[0, d], planes[1, d], planes[2, d, :, None], db2


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


def _din_weight_grads(hx, dapre, cand, dsum, hist=None) -> torch.Tensor:
    """dw1 [4D, H] from the per-step terms: hx = [h, h*c] [B*T, 2D] (or
    h*c alone [B*T, D], `hx_alone`, with the history [B, T, D] as `hist`),
    dapre [B*T, H], cand [B, D] and dsum = sum_t dapre_t [B, H]. The
    gradient of the folded weight [wa+wb; wc-wa; wd] is [dk0; dk1; dk2]
    with [dk0; dk2] = hx^T dapre (h^T dapre and (h*c)^T dapre apart where
    h*c comes alone) and dk1 = c^T dsum (`_tn` each), unfolded to
    dwa = dk0 - dk1, dwb = dk0, dwc = dk1, dwd = dk2. One product on
    [h, h*c] reads dapre once: where D < H (the training shape) that is
    faster on the H100 than two, for all that the kernel writes a copy of
    h; where D > H the copy costs more (`chip_smoke.py` times both). They
    follow PyTorch's float32 matmul precision, like every other matmul of
    the model: full float32 unless the caller allows TF32
    (`torch.backends.cuda.matmul.allow_tf32`)."""
    d = cand.shape[1]
    dk1 = _tn(cand, dsum)
    if hx.shape[1] == d:
        dk0, dk2 = _tn(hist.reshape(-1, d), dapre), _tn(hx, dapre)
    else:
        dk02 = _tn(hx, dapre)
        dk0, dk2 = dk02[:d], dk02[d:]
    return torch.cat([dk0 - dk1, dk0, dk1, dk2], dim=0)


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


_FWD, _BWD_GRID, _BWD, _NARROW_FWD, _NARROW_BWD = (
    kernels.TABLE[n] for n in ("din_attention", "din_attention_bwd.grid", "din_attention_bwd",
                               "din_attention.narrow", "din_attention_bwd.narrow"))


def _din_attention_kernel(hist, cand, w1, b1, alpha, w2, b2) -> torch.Tensor:
    dev, b, t, d, h = _check("din_attention", hist, cand, w1, b1, alpha, w2, b2)
    if b * t * d == 0:
        return hist.new_zeros((b, d))
    out = hist.new_empty((b, d))
    ptrs = (hist.data_ptr(), cand.data_ptr(), w1.data_ptr(), b1.data_ptr(), alpha.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), out.data_ptr())
    if narrow(d, h):
        _NARROW_FWD(dev, *ptrs, kernels.scalars(b, t, d, h, unit_rows(b, t), dev))
    else:
        _FWD(dev, *ptrs, _tc_scalars(b, t, d, h, dev))
    return out


#: The backward's grid per (B, T, D, H, device): the C side sizes it
#: from the kernel's occupancy, and the wrapper sizes the
#: [grid * warps, 3H+1] scratch (a row per warp) by it.
_bwd_grids: dict = {}


def _din_attention_bwd_steps(hist, cand, w1, b1, alpha, w2, b2, g):
    """The per-step backward kernel's outputs (`din_attention_bwd_steps_plain`)."""
    dev, b, t, d, h = _check("din_attention_bwd", hist, cand, w1, b1, alpha, w2, b2, g)
    hx_width = d if hx_alone(d, h) else 2 * d
    if b * t * d == 0:
        z = hist.new_zeros
        return (z(hist.shape), z(cand.shape), z((b * t, h)), z((b * t, hx_width)), z((b, h)),
                z(3 * h + 1))
    scalars = _tc_scalars(b, t, d, h, dev, True)
    key = (b, t, d, h, dev)
    grid = _bwd_grids.get(key)
    if grid is None:
        got = ctypes.c_int64(0)
        _BWD_GRID(scalars, ctypes.addressof(got))
        grid = _bwd_grids[key] = got.value
    new = hist.new_empty
    dh, dc, dsum, small = new(hist.shape), new(cand.shape), new((b, h)), new(3 * h + 1)
    dapre, hx = new((b * t, h)), new((b * t, hx_width))
    partial = new((grid * plan(t, d, h, True).warps, 3 * h + 1))
    _BWD(dev, hist.data_ptr(), cand.data_ptr(), w1.data_ptr(), b1.data_ptr(), alpha.data_ptr(),
         w2.data_ptr(), b2.data_ptr(), g.data_ptr(), dh.data_ptr(), dc.data_ptr(),
         dapre.data_ptr(), hx.data_ptr(), dsum.data_ptr(), partial.data_ptr(), small.data_ptr(),
         scalars, grid)
    return dh, dc, dapre, hx, dsum, small


def _din_narrow_bwd(hist, cand, w1, b1, alpha, w2, b2, g):
    """The seven gradients from the narrow kernel and its reduce: dh, dc,
    and one buffer [dw1 | db1 | dalpha | dw2 | db2] returned as views."""
    dev, b, t, d, h = _check("din_attention_bwd", hist, cand, w1, b1, alpha, w2, b2, g)
    n = 4 * d * h
    if b * t * d == 0:
        grads = hist.new_zeros(n + 3 * h + 1)
        dh, dc = hist.new_zeros(hist.shape), hist.new_zeros(cand.shape)
    else:
        new = hist.new_empty
        dh, dc, grads = new(hist.shape), new(cand.shape), new(n + 3 * h + 1)
        rows = unit_rows(b, t)
        partial = new((-(-b // rows), narrow_partial_width(d)))
        _NARROW_BWD(dev, hist.data_ptr(), cand.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                    alpha.data_ptr(), w2.data_ptr(), b2.data_ptr(), g.data_ptr(), dh.data_ptr(),
                    dc.data_ptr(), partial.data_ptr(), grads.data_ptr(),
                    kernels.scalars(b, t, d, h, rows, dev))
    return (dh, dc, grads[:n].view(4 * d, h), grads[n:n + h], grads[n + h:n + 2 * h],
            grads[n + 2 * h:n + 3 * h, None], grads[n + 3 * h:])


def din_attention_bwd(hist, cand, w1, b1, alpha, w2, b2, g):
    """The seven input gradients of `din_attention` for the output
    gradient g [B, D]. On the card at narrow widths (`narrow`), all from
    the narrow kernel; else the per-step terms from the tensor-core kernel
    (the plain version for a CPU tensor) and dw1 from
    `_din_weight_grads`."""
    hist, cand = _as_f32(hist, cand)
    if hist.device.type != "cpu" and narrow(hist.shape[-1], w1.shape[-1]):
        return _din_narrow_bwd(hist, cand, w1, b1, alpha, w2, b2, g)
    steps = din_attention_bwd_steps_plain if hist.device.type == "cpu" else _din_attention_bwd_steps
    dh, dc, dapre, hx, dsum, small = steps(hist, cand, w1, b1, alpha, w2, b2, g)
    h = dapre.shape[-1]
    dw1 = _din_weight_grads(hx, dapre, cand, dsum, hist)
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

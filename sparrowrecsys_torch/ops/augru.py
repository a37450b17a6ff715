"""DIEN's GRU and attention-gated AUGRU recurrences: the port of
`sparrowrecsys_tpu/ops/augru.py`.

- `gru`: a GRU over [B, T, D] returning every hidden state. The reset
  gate r is applied to h before the recurrent product (the reference's
  math, JAX `augru.py:64-73`), which is not `torch.nn.GRU`'s or cuDNN's
  reset-after form, so neither is used.
- `augru`: the reference's AUGRU cell, whose mixer is its "R" gate scaled
  by the step's attention: h <- (1 - a r) h + a r h~, with
  r = sigmoid(W_r x + U_r h), z = sigmoid(W_z x + U_z h),
  h~ = tanh(W_h x + U_h (h z)) (JAX `augru.py:8-13, :251-262`).

Both start from h0 = 0 and hoist the input projections out of the
recurrence into one product over [B*T, D]; `gru_recurrence` and
`augru_recurrence` run the steps that follow.

On the card (float32 projections, H <= MAX_HIDDEN) each recurrence is one
launch a direction: `gru_scan_fwd`, `gru_scan_bwd`, `augru_scan_fwd` and
`augru_scan_bwd`, the kernels of `csrc/recurrence.cu`, inside
`torch.autograd.Function`s (`_GRUKernel`, `_AUGRUKernel`). The backward
kernels run the reverse dh chain and write the stacked pre-activation
gradients and the operands of the weight gradients, which are one product
each over the stacked [B*T, H] steps. The AUGRU's attention is one scalar
a step ([B, T, 1], or that expanded over H). Each kernel has a plain
PyTorch twin (`*_plain`) that repeats its arithmetic in its order, which
its wrapper takes for CPU tensors.

Everything else (the CPU, other dtypes, wider states, an attention that
differs over H) takes the plain path, T eager steps with autograd: the
JAX package runs the steps as `lax.scan` and plain products, not as a
Pallas kernel. `custom_vjp=True` asks for the hand-written backward:
on the CPU the same Functions, on the twins, where only the dh chain
stays in the reverse loop and each weight gradient is one product over
the stacked [B*T, H] pre-activation gradients (JAX `_gru_scan_bwd` :119,
`_augru_scan_bwd` :304); where neither the kernels nor the twins take a
recurrence it is the plain path. `remat=True` recomputes each plain
step's gates in the backward (`torch.utils.checkpoint`) instead of
keeping them. The two are exclusive. Neither changes the kernels' path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from sparrowrecsys_torch.ops import kernels

#: The widest state the kernels take (`kMaxHidden` in csrc/recurrence.cu).
MAX_HIDDEN = 32
#: Devices whose recurrences take the kernels.
_KERNEL_DEVICES = ("cuda",)


class GRUParams(NamedTuple):
    """Keras GRU layout: kernel [D, 3H] (z|r|h), recurrent [H, 3H], bias [3H]."""

    kernel: torch.Tensor
    recurrent: torch.Tensor
    bias: torch.Tensor


class AUGRUGate(NamedTuple):
    """One gate: y = act(x @ w + b + h @ u); w [D, H], b [H], u [H, H]."""

    w: torch.Tensor
    b: torch.Tensor
    u: torch.Tensor


class AUGRUParams(NamedTuple):
    r: AUGRUGate
    z: AUGRUGate
    h: AUGRUGate


# ---- GRU ----------------------------------------------------------------------


def _gru_step(recurrent, h, gx, m):
    """One step: h [B, H], gx [B, 3H] (input projections), m [B] bool ->
    (h_new, z, r, hh). A masked step carries h."""
    hd = h.shape[-1]
    xz, xr, xh = gx.split(hd, dim=-1)
    rz = h @ recurrent[:, : 2 * hd]
    z = torch.sigmoid(xz + rz[:, :hd])
    r = torch.sigmoid(xr + rz[:, hd:])
    hh = torch.tanh(xh + (r * h) @ recurrent[:, 2 * hd:])
    h_new = torch.where(m[:, None], z * h + (1.0 - z) * hh, h)
    return h_new, z, r, hh


def _gru_scan(recurrent, gx, mask, h0, remat: bool = False):
    """Time-major: gx [T, B, 3H], mask [T, B] -> hs [T, B, H], autograd
    through the loop (each step checkpointed with `remat`)."""
    h, hs = h0, []
    # One unbind, not gx[t]: each slice's backward would write a zeroed
    # gradient of the whole sequence, T times.
    for g_t, m_t in zip(gx.unbind(0), mask.unbind(0)):
        if remat:
            h = checkpoint(lambda *a: _gru_step(*a)[0], recurrent, h, g_t, m_t,
                           use_reentrant=False)
        else:
            h = _gru_step(recurrent, h, g_t, m_t)[0]
        hs.append(h)
    return torch.stack(hs)


def gru(
    params: GRUParams,
    x: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    custom_vjp: bool = False,
    remat: bool = False,
) -> torch.Tensor:
    """x [B, T, D] -> hidden states [B, T, H], from h0 = 0.

    mask [B, T] bool (optional): a False step carries the previous state
    unchanged (Keras's mask_zero). The state stays in the projections'
    dtype (float32) whatever the dtype of x. `custom_vjp` and `remat`
    choose the backward off the kernels' path (the module's docstring)."""
    if custom_vjp and remat:
        raise ValueError("gru: custom_vjp and remat are mutually exclusive")
    kernel = params.kernel
    gx = x.to(kernel.dtype) @ kernel + params.bias                    # [B, T, 3H]
    if mask is None:
        mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
    return gru_recurrence(params.recurrent, gx, mask, custom_vjp, remat)


def gru_recurrence(recurrent: torch.Tensor, gx: torch.Tensor, mask: torch.Tensor,
                   custom_vjp: bool = False, remat: bool = False) -> torch.Tensor:
    """The GRU's steps alone: gx [B, T, 3H] (the input projections, z|r|h),
    mask [B, T] bool -> hidden states [B, T, H], from h0 = 0. On the card
    (`takes_kernel`) one launch a direction; with `custom_vjp`, CPU tensors
    take the same Function on the twins; else the plain loop."""
    if takes_kernel(gx, recurrent) or (custom_vjp and gx.is_cpu):
        return _GRUKernel.apply(recurrent, gx.contiguous(), mask.contiguous())
    h0 = gx.new_zeros(gx.shape[0], recurrent.shape[0])
    hs = _gru_scan(recurrent, gx.transpose(0, 1), mask.transpose(0, 1), h0, remat)
    return hs.transpose(0, 1)


# ---- AUGRU --------------------------------------------------------------------


def _augru_step(u_rz, u_h, h, x, at):
    """One step: h [B, H], x [B, 3H] (r|z|h projections), at [B, H] ->
    (h_new, r, z, h_tilde)."""
    hd = h.shape[-1]
    xr, xz, xh = x.split(hd, dim=-1)
    rz = h @ u_rz
    r = torch.sigmoid(xr + rz[:, :hd])
    z = torch.sigmoid(xz + rz[:, hd:])
    h_tilde = torch.tanh(xh + (h * z) @ u_h)
    a = at * r
    return (1.0 - a) * h + a * h_tilde, r, z, h_tilde


def _augru_scan(u_rz, u_h, x_all, att, h0, remat: bool = False):
    """Time-major: x_all [T, B, 3H], att [T, B, H] -> final h [B, H]."""
    h = h0
    for x_t, a_t in zip(x_all.unbind(0), att.unbind(0)):
        if remat:
            h = checkpoint(lambda *a: _augru_step(*a)[0], u_rz, u_h, h, x_t, a_t,
                           use_reentrant=False)
        else:
            h = _augru_step(u_rz, u_h, h, x_t, a_t)[0]
    return h


def augru(
    params: AUGRUParams,
    states: torch.Tensor,
    attention: torch.Tensor,
    custom_vjp: bool = False,
    remat: bool = False,
) -> torch.Tensor:
    """states [B, T, H] (the GRU's hidden states), attention [B, T, H] or
    [B, T, 1] -> the final state [B, H], from h0 = 0. `custom_vjp` and
    `remat` choose the backward off the kernels' path (the module's docstring)."""
    if custom_vjp and remat:
        raise ValueError("augru: custom_vjp and remat are mutually exclusive")
    wx = torch.cat([params.r.w, params.z.w, params.h.w], dim=1)
    bx = torch.cat([params.r.b, params.z.b, params.h.b])
    x_all = states @ wx + bx                                          # [B, T, 3H]
    u_rz = torch.cat([params.r.u, params.z.u], dim=1)                # [H, 2H]
    return augru_recurrence(u_rz, params.h.u, x_all, attention, custom_vjp, remat)


def _step_attention(attention: torch.Tensor) -> Optional[torch.Tensor]:
    """A [B, T, 1] attention, or one expanded over H from it, as [B, T];
    None for an attention that differs over H."""
    if attention.shape[-1] == 1 or attention.stride(-1) == 0:
        return attention[..., 0]
    return None


def augru_recurrence(u_rz: torch.Tensor, u_h: torch.Tensor, x_all: torch.Tensor,
                     attention: torch.Tensor, custom_vjp: bool = False,
                     remat: bool = False) -> torch.Tensor:
    """The AUGRU's steps alone: x_all [B, T, 3H] (the input projections,
    r|z|h), u_rz [H, 2H], u_h [H, H], attention [B, T, H] or [B, T, 1] ->
    the final state [B, H], from h0 = 0. On the card (`takes_kernel`, and
    one attention scalar a step) one launch a direction; with `custom_vjp`,
    CPU tensors with one attention scalar a step take the same Function on
    the twins; else the plain loop."""
    b, t, h3 = x_all.shape
    hd = h3 // 3
    fits = takes_kernel(x_all, u_rz, u_h) or (custom_vjp and x_all.is_cpu)
    att = _step_attention(attention) if fits else None
    if att is not None:
        return _AUGRUKernel.apply(u_rz, u_h, x_all.contiguous(), att.contiguous())
    att = attention.expand(b, t, hd).transpose(0, 1)
    h0 = x_all.new_zeros(b, hd)
    return _augru_scan(u_rz, u_h, x_all.transpose(0, 1), att, h0, remat)


# ---- the kernels' path ----------------------------------------------------------


def kernel_fits(h: int) -> bool:
    """Whether the kernels take a state of width H."""
    return 1 <= h <= MAX_HIDDEN


def takes_kernel(x: torch.Tensor, *weights: torch.Tensor) -> bool:
    """Whether a recurrence over the projections x [B, T, 3H] with these
    recurrent weights ([H, .]) runs on the kernels: float32 on the card,
    H within `kernel_fits`."""
    return (x.device.type in _KERNEL_DEVICES and x.dim() == 3 and x.dtype is torch.float32
            and all(w.dtype is torch.float32 and w.device == x.device for w in weights)
            and x.shape[-1] % 3 == 0 and kernel_fits(x.shape[-1] // 3)
            and all(w.shape[0] == x.shape[-1] // 3 for w in weights))


def _sum_k(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """v [B, K] @ u [K, N] as the kernels sum it: k ascending, one product
    added at a time."""
    acc = v[:, :1] * u[0]
    for k in range(1, u.shape[0]):
        acc = acc + v[:, k:k + 1] * u[k]
    return acc


def _gru_gates_plain(u, hp, x):
    """The GRU's (z, r, hh) from the previous state hp [B, H] and the step's
    projections x [B, 3H], in the kernels' order."""
    h = hp.shape[1]
    z = torch.sigmoid(x[:, :h] + _sum_k(hp, u[:, :h]))
    r = torch.sigmoid(x[:, h:2 * h] + _sum_k(hp, u[:, h:2 * h]))
    hh = torch.tanh(x[:, 2 * h:] + _sum_k(r * hp, u[:, 2 * h:]))
    return z, r, hh


def _augru_gates_plain(u_rz, u_h, hp, x):
    """The AUGRU's (r, z, h~) from hp [B, H] and x [B, 3H], in the kernels'
    order."""
    h = hp.shape[1]
    r = torch.sigmoid(x[:, :h] + _sum_k(hp, u_rz[:, :h]))
    z = torch.sigmoid(x[:, h:2 * h] + _sum_k(hp, u_rz[:, h:]))
    ht = torch.tanh(x[:, 2 * h:] + _sum_k(hp * z, u_h))
    return r, z, ht


def gru_scan_fwd_plain(recurrent, gx, mask):
    """`gru_scan_fwd`'s twin: hs [B, T, H] from gx [B, T, 3H], mask [B, T]."""
    b, t, h3 = gx.shape
    h = h3 // 3
    hs = gx.new_empty(b, t, h)
    hc = gx.new_zeros(b, h)
    for i in range(t):
        z, r, hh = _gru_gates_plain(recurrent, hc, gx[:, i])
        hc = torch.where(mask[:, i, None], z * hc + (1.0 - z) * hh, hc)
        hs[:, i] = hc
    return hs


def gru_scan_bwd_plain(recurrent, gx, mask, hs, dhs):
    """`gru_scan_bwd`'s twin: (dgx [B, T, 3H] = [dz|dr|dh~ pre-activation],
    ops [B, T, 2H] = [h_prev | r h_prev], dh0 [B, H])."""
    b, t, h3 = gx.shape
    h = h3 // 3
    dgx, ops = gx.new_empty(b, t, 3 * h), gx.new_empty(b, t, 2 * h)
    u_h = recurrent[:, 2 * h:]
    dh = gx.new_zeros(b, h)
    zero = gx.new_zeros(())
    for i in reversed(range(t)):
        hp = hs[:, i - 1] if i else gx.new_zeros(b, h)
        z, r, hh = _gru_gates_plain(recurrent, hp, gx[:, i])
        d = dh + dhs[:, i]
        m = mask[:, i, None]
        dz = torch.where(m, d * (hp - hh), zero)
        dhh = torch.where(m, d * (1.0 - z), zero)
        dprev = torch.where(m, d * z, d)
        dph = dhh * (1.0 - hh * hh)
        drh = _sum_k(dph, u_h.T)
        dr = drh * hp
        dprev = dprev + drh * r
        dpzr = torch.cat([dz * z * (1.0 - z), dr * r * (1.0 - r)], dim=1)
        dh = dprev + _sum_k(dpzr, recurrent[:, :2 * h].T)
        dgx[:, i] = torch.cat([dpzr, dph], dim=1)
        ops[:, i] = torch.cat([hp, r * hp], dim=1)
    return dgx, ops, dh


def augru_scan_fwd_plain(u_rz, u_h, x_all, att):
    """`augru_scan_fwd`'s twin: (h_final [B, H], hs [B, T, H]) from x_all
    [B, T, 3H] and att [B, T]."""
    b, t, h3 = x_all.shape
    h = h3 // 3
    hs = x_all.new_empty(b, t, h)
    hc = x_all.new_zeros(b, h)
    for i in range(t):
        r, _, ht = _augru_gates_plain(u_rz, u_h, hc, x_all[:, i])
        a = att[:, i, None] * r
        hc = (1.0 - a) * hc + a * ht
        hs[:, i] = hc
    return hc.clone(), hs


def augru_scan_bwd_plain(u_rz, u_h, x_all, att, hs, dh_fin):
    """`augru_scan_bwd`'s twin: (dx [B, T, 3H] = [dr|dz|dh~ pre-activation],
    ops [B, T, 2H] = [h_prev | h_prev z], datt [B, T], dh0 [B, H])."""
    b, t, h3 = x_all.shape
    h = h3 // 3
    dx, ops = x_all.new_empty(b, t, 3 * h), x_all.new_empty(b, t, 2 * h)
    datt = x_all.new_empty(b, t)
    dh = dh_fin
    for i in reversed(range(t)):
        hp = hs[:, i - 1] if i else x_all.new_zeros(b, h)
        r, z, ht = _augru_gates_plain(u_rz, u_h, hp, x_all[:, i])
        at = att[:, i, None]
        a = at * r
        da = dh * (ht - hp)
        dprev = dh * (1.0 - a)
        dar = da * r
        s = dar[:, 0]
        for j in range(1, h):
            s = s + dar[:, j]
        datt[:, i] = s
        dph = (dh * a) * (1.0 - ht * ht)
        dhz = _sum_k(dph, u_h.T)
        dz = dhz * hp
        dprev = dprev + dhz * z
        dprz = torch.cat([(da * at) * r * (1.0 - r), dz * z * (1.0 - z)], dim=1)
        dh = dprev + _sum_k(dprz, u_rz.T)
        dx[:, i] = torch.cat([dprz, dph], dim=1)
        ops[:, i] = torch.cat([hp, hp * z], dim=1)
    return dx, ops, datt, dh


def _checked(name: str, x: torch.Tensor, mask: Optional[torch.Tensor],
             *shaped: Tuple[torch.Tensor, str]) -> Tuple[int, int, int, int]:
    """(B, T, H, device) of a launch on x [B, T, 3H]; raises unless H fits,
    every tensor is contiguous float32 on x's card with the shape given
    beside it (dims named from "b", "t", "h", "2h", "3h"), and the mask is
    bool [B, T] there."""
    dev = kernels.require_cuda(name, x, *(t for t, _ in shaped))
    b, t, h3 = x.shape
    h = h3 // 3
    if h3 % 3 or not kernel_fits(h):
        raise ValueError(f"{name}: a state of width {h3 / 3} is outside [1, {MAX_HIDDEN}]")
    dims = {"b": b, "t": t, "h": h, "2h": 2 * h, "3h": 3 * h}
    for tensor, spec in shaped:
        want = tuple(dims[k] for k in spec.split(","))
        if tuple(tensor.shape) != want:
            raise ValueError(f"{name}: a tensor of shape {tuple(tensor.shape)} where "
                             f"[{spec}] = {list(want)} was expected")
    if mask is not None:
        if kernels.require_cuda(name, mask, dtypes=(torch.bool,)) != dev \
                or tuple(mask.shape) != (b, t):
            raise ValueError(f"{name}: mask {tuple(mask.shape)} on {mask.device} for x "
                             f"{tuple(x.shape)}")
    return b, t, h, dev


_GRU_FWD, _GRU_BWD, _AUGRU_FWD, _AUGRU_BWD = (
    kernels.TABLE[n] for n in ("gru_scan_fwd", "gru_scan_bwd", "augru_scan_fwd",
                               "augru_scan_bwd"))


def gru_scan_fwd(recurrent: torch.Tensor, gx: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The GRU's steps from h0 = 0: gx [B, T, 3H] (z|r|h), recurrent [H, 3H],
    mask [B, T] bool -> hs [B, T, H]. A CPU tensor takes the twin; a CUDA
    tensor launches `gru_scan_fwd_kernel` or raises."""
    if gx.is_cpu:
        return gru_scan_fwd_plain(recurrent, gx, mask)
    b, t, h, dev = _checked("gru_scan_fwd", gx, mask, (recurrent, "h,3h"))
    hs = gx.new_empty(b, t, h)
    if b and t:
        _GRU_FWD(dev, gx.data_ptr(), recurrent.data_ptr(), mask.data_ptr(), hs.data_ptr(),
                 kernels.scalars(b, t, h, dev))
    return hs


def gru_scan_bwd(recurrent, gx, mask, hs, dhs):
    """The GRU's reverse dh chain for the output gradient dhs [B, T, H]:
    (dgx [B, T, 3H], ops [B, T, 2H] = [h_prev | r h_prev], dh0 [B, H]), the
    forward's gates recomputed from gx and hs. A CPU tensor takes the
    twin; a CUDA tensor launches `gru_scan_bwd_kernel` or raises."""
    if gx.is_cpu:
        return gru_scan_bwd_plain(recurrent, gx, mask, hs, dhs)
    b, t, h, dev = _checked("gru_scan_bwd", gx, mask, (recurrent, "h,3h"), (hs, "b,t,h"),
                          (dhs, "b,t,h"))
    dgx, ops, dh0 = gx.new_empty(b, t, 3 * h), gx.new_empty(b, t, 2 * h), gx.new_zeros(b, h)
    if b and t:
        _GRU_BWD(dev, gx.data_ptr(), recurrent.data_ptr(), mask.data_ptr(), hs.data_ptr(),
                 dhs.data_ptr(), dgx.data_ptr(), ops.data_ptr(), dh0.data_ptr(),
                 kernels.scalars(b, t, h, dev))
    return dgx, ops, dh0


def augru_scan_fwd(u_rz, u_h, x_all, att):
    """The AUGRU's steps from h0 = 0: x_all [B, T, 3H] (r|z|h), u_rz
    [H, 2H], u_h [H, H], att [B, T] -> (h_final [B, H], hs [B, T, H]). A
    CPU tensor takes the twin; a CUDA tensor launches
    `augru_scan_fwd_kernel` or raises."""
    if x_all.is_cpu:
        return augru_scan_fwd_plain(u_rz, u_h, x_all, att)
    b, t, h, dev = _checked("augru_scan_fwd", x_all, None, (u_rz, "h,2h"), (u_h, "h,h"),
                          (att, "b,t"))
    hs, hfin = x_all.new_empty(b, t, h), x_all.new_zeros(b, h)
    if b and t:
        _AUGRU_FWD(dev, x_all.data_ptr(), u_rz.data_ptr(), u_h.data_ptr(), att.data_ptr(),
                   hs.data_ptr(), hfin.data_ptr(), kernels.scalars(b, t, h, dev))
    return hfin, hs


def augru_scan_bwd(u_rz, u_h, x_all, att, hs, dh_fin):
    """The AUGRU's reverse dh chain for the final state's gradient dh_fin
    [B, H]: (dx [B, T, 3H], ops [B, T, 2H] = [h_prev | h_prev z], datt
    [B, T], dh0 [B, H]). A CPU tensor takes the twin; a CUDA tensor
    launches `augru_scan_bwd_kernel` or raises."""
    if x_all.is_cpu:
        return augru_scan_bwd_plain(u_rz, u_h, x_all, att, hs, dh_fin)
    b, t, h, dev = _checked("augru_scan_bwd", x_all, None, (u_rz, "h,2h"), (u_h, "h,h"),
                          (att, "b,t"), (hs, "b,t,h"), (dh_fin, "b,h"))
    dx, ops = x_all.new_empty(b, t, 3 * h), x_all.new_empty(b, t, 2 * h)
    datt, dh0 = x_all.new_zeros(b, t), dh_fin.clone()
    if b and t:
        _AUGRU_BWD(dev, x_all.data_ptr(), u_rz.data_ptr(), u_h.data_ptr(), att.data_ptr(),
                   hs.data_ptr(), dh_fin.data_ptr(), dx.data_ptr(), ops.data_ptr(),
                   datt.data_ptr(), dh0.data_ptr(), kernels.scalars(b, t, h, dev))
    return dx, ops, datt, dh0


def _weight_grads(ops: torch.Tensor, dpre: torch.Tensor) -> torch.Tensor:
    """[H, 3H]: the first two gates' recurrent gradient (ops' h_prev half
    against dpre's first 2H columns) beside the candidate's (ops' second
    half against dpre's last H), each one product over the stacked B*T
    steps."""
    h = ops.shape[-1] // 2
    o, d = ops.reshape(-1, 2 * h), dpre.reshape(-1, 3 * h)
    return torch.cat([o[:, :h].T @ d[:, :2 * h], o[:, h:].T @ d[:, 2 * h:]], dim=1)


class _GRUKernel(torch.autograd.Function):
    """`gru_recurrence` on the kernels: forward `gru_scan_fwd`, backward
    `gru_scan_bwd` and the recurrent weight's gradient."""

    @staticmethod
    def forward(ctx, recurrent, gx, mask):
        hs = gru_scan_fwd(recurrent, gx, mask)
        ctx.save_for_backward(recurrent, gx, mask, hs)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        recurrent, gx, mask, hs = ctx.saved_tensors
        dgx, ops, _ = gru_scan_bwd(recurrent, gx, mask, hs, dhs.contiguous())
        return _weight_grads(ops, dgx), dgx, None


class _AUGRUKernel(torch.autograd.Function):
    """`augru_recurrence` on the kernels: forward `augru_scan_fwd`, backward
    `augru_scan_bwd` and the recurrent weights' gradients."""

    @staticmethod
    def forward(ctx, u_rz, u_h, x_all, att):
        hfin, hs = augru_scan_fwd(u_rz, u_h, x_all, att)
        ctx.save_for_backward(u_rz, u_h, x_all, att, hs)
        return hfin

    @staticmethod
    def backward(ctx, dh_fin):
        u_rz, u_h, x_all, att, hs = ctx.saved_tensors
        dx, ops, datt, _ = augru_scan_bwd(u_rz, u_h, x_all, att, hs, dh_fin.contiguous())
        du = _weight_grads(ops, dx)
        h = u_h.shape[0]
        return du[:, :2 * h], du[:, 2 * h:], dx, datt

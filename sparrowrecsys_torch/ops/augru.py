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
recurrence into one product over [B*T, D]. The JAX package runs the
steps as `lax.scan` and plain products, not as a Pallas kernel, so they
are plain PyTorch here: T eager steps, each a handful of launches.

`custom_vjp=True` runs the hand-written backward (a
`torch.autograd.Function`): only the dh chain stays in the reverse loop,
and each weight gradient is one product over the stacked [T*B, H]
pre-activation gradients, outside it (JAX `_gru_scan_bwd` :119,
`_augru_scan_bwd` :304). `remat=True` recomputes each step's gates in
the backward (`torch.utils.checkpoint`) instead of keeping them. The
two are exclusive: the custom backward keeps its own residuals.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint


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
    for t in range(gx.shape[0]):
        if remat:
            h = checkpoint(lambda *a: _gru_step(*a)[0], recurrent, h, gx[t], mask[t],
                           use_reentrant=False)
        else:
            h = _gru_step(recurrent, h, gx[t], mask[t])[0]
        hs.append(h)
    return torch.stack(hs)


class _GRUScan(torch.autograd.Function):
    """`_gru_scan` with the hand-written backward."""

    @staticmethod
    def forward(ctx, recurrent, gx, mask, h0):
        h, outs = h0, []
        for t in range(gx.shape[0]):
            h, z, r, hh = _gru_step(recurrent, h, gx[t], mask[t])
            outs.append((h, z, r, hh))
        hs, z, r, hh = (torch.stack(o) for o in zip(*outs))
        ctx.save_for_backward(recurrent, mask, h0, hs, z, r, hh)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        recurrent, mask, h0, hs, z, r, hh = ctx.saved_tensors
        hd = h0.shape[-1]
        u_zr, u_h = recurrent[:, : 2 * hd], recurrent[:, 2 * hd:]
        h_prevs = torch.cat([h0[None], hs[:-1]])                      # [T, B, H]
        t_len = hs.shape[0]
        d_pre_zr = hs.new_empty(t_len, hs.shape[1], 2 * hd)
        d_pre_h = torch.empty_like(hs)
        dh_carry = torch.zeros_like(h0)
        for t in reversed(range(t_len)):
            hp, zt, rt, hht = h_prevs[t], z[t], r[t], hh[t]
            dh = dh_carry + dhs[t]
            m = mask[t][:, None]
            dh_upd = torch.where(m, dh, 0.0)
            dh_prev = torch.where(m, 0.0, dh)
            # h_upd = z*h + (1-z)*hh
            dz = dh_upd * (hp - hht)
            dhh = dh_upd * (1.0 - zt)
            dh_prev = dh_prev + dh_upd * zt
            # hh = tanh(xh + (r*h) @ u_h)
            dph = dhh * (1.0 - hht * hht)
            d_rh = dph @ u_h.T
            dr = d_rh * hp
            dh_prev = dh_prev + d_rh * rt
            # z and r share one recurrent product: [dz|dr] @ u_zr.T
            dpzr = torch.cat([dz * zt * (1.0 - zt), dr * rt * (1.0 - rt)], dim=-1)
            dh_prev = dh_prev + dpzr @ u_zr.T
            d_pre_zr[t], d_pre_h[t] = dpzr, dph
            dh_carry = dh_prev
        # The weight gradients: one product each over the stacked steps.
        tb = t_len * hs.shape[1]
        du_zr = h_prevs.reshape(tb, hd).T @ d_pre_zr.reshape(tb, 2 * hd)
        du_h = (r * h_prevs).reshape(tb, hd).T @ d_pre_h.reshape(tb, hd)
        d_recurrent = torch.cat([du_zr, du_h], dim=1)
        dgx = torch.cat([d_pre_zr, d_pre_h], dim=-1)
        return d_recurrent, dgx, None, dh_carry


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
    dtype (float32) whatever the dtype of x."""
    if custom_vjp and remat:
        raise ValueError("gru: custom_vjp and remat are mutually exclusive")
    kernel = params.kernel
    gx = x.to(kernel.dtype) @ kernel + params.bias                    # [B, T, 3H]
    if mask is None:
        mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
    h0 = gx.new_zeros(x.shape[0], params.recurrent.shape[0])
    gx, mask = gx.transpose(0, 1), mask.transpose(0, 1)
    if custom_vjp:
        hs = _GRUScan.apply(params.recurrent, gx, mask, h0)
    else:
        hs = _gru_scan(params.recurrent, gx, mask, h0, remat)
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
    for t in range(x_all.shape[0]):
        if remat:
            h = checkpoint(lambda *a: _augru_step(*a)[0], u_rz, u_h, h, x_all[t], att[t],
                           use_reentrant=False)
        else:
            h = _augru_step(u_rz, u_h, h, x_all[t], att[t])[0]
    return h


class _AUGRUScan(torch.autograd.Function):
    """`_augru_scan` with the hand-written backward."""

    @staticmethod
    def forward(ctx, u_rz, u_h, x_all, att, h0):
        h, outs = h0, []
        for t in range(x_all.shape[0]):
            h_new, r, z, ht = _augru_step(u_rz, u_h, h, x_all[t], att[t])
            outs.append((h, r, z, ht))
            h = h_new
        h_prevs, r, z, ht = (torch.stack(o) for o in zip(*outs))
        ctx.save_for_backward(u_rz, u_h, att, h_prevs, r, z, ht)
        return h

    @staticmethod
    def backward(ctx, dh_fin):
        u_rz, u_h, att, h_prevs, r, z, h_tilde = ctx.saved_tensors
        hd = h_prevs.shape[-1]
        t_len = h_prevs.shape[0]
        d_pre_rz = h_prevs.new_empty(t_len, h_prevs.shape[1], 2 * hd)
        d_pre_h = torch.empty_like(h_prevs)
        datt = torch.empty_like(h_prevs)
        dh = dh_fin
        for t in reversed(range(t_len)):
            at, hp, rt, zt, ht = att[t], h_prevs[t], r[t], z[t], h_tilde[t]
            a = at * rt
            # h_new = (1-a)*h + a*h_tilde
            da = dh * (ht - hp)
            dh_tilde = dh * a
            dh_prev = dh * (1.0 - a)
            datt[t] = da * rt
            dr = da * at
            # h_tilde = tanh(xh + (h*z) @ u_h)
            dph = dh_tilde * (1.0 - ht * ht)
            d_hz = dph @ u_h.T
            dz = d_hz * hp
            dh_prev = dh_prev + d_hz * zt
            # r and z share one recurrent product: [dr|dz] @ u_rz.T
            dprz = torch.cat([dr * rt * (1.0 - rt), dz * zt * (1.0 - zt)], dim=-1)
            dh_prev = dh_prev + dprz @ u_rz.T
            d_pre_rz[t], d_pre_h[t] = dprz, dph
            dh = dh_prev
        tb = t_len * h_prevs.shape[1]
        du_rz = h_prevs.reshape(tb, hd).T @ d_pre_rz.reshape(tb, 2 * hd)
        du_h = (h_prevs * z).reshape(tb, hd).T @ d_pre_h.reshape(tb, hd)
        dx_all = torch.cat([d_pre_rz, d_pre_h], dim=-1)
        return du_rz, du_h, dx_all, datt, dh


def augru(
    params: AUGRUParams,
    states: torch.Tensor,
    attention: torch.Tensor,
    custom_vjp: bool = False,
    remat: bool = False,
) -> torch.Tensor:
    """states [B, T, H] (the GRU's hidden states), attention [B, T, H] ->
    the final state [B, H], from h0 = 0."""
    if custom_vjp and remat:
        raise ValueError("augru: custom_vjp and remat are mutually exclusive")
    b, _, hd = states.shape
    wx = torch.cat([params.r.w, params.z.w, params.h.w], dim=1)
    bx = torch.cat([params.r.b, params.z.b, params.h.b])
    x_all = (states @ wx + bx).transpose(0, 1)                       # [T, B, 3H]
    u_rz = torch.cat([params.r.u, params.z.u], dim=1)                # [H, 2H]
    att = attention.transpose(0, 1)
    h0 = states.new_zeros(b, hd)
    if custom_vjp:
        return _AUGRUScan.apply(u_rz, params.h.u, x_all, att, h0)
    return _augru_scan(u_rz, params.h.u, x_all, att, h0, remat)

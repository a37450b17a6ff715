"""The port's GRU and AUGRU recurrences (`ops/augru.py`) against the JAX
package's on the CPU: outputs and the gradients of a random projection of
them for every input and weight, with and without a mask, through the
autodiff loop, the hand-written backward (`custom_vjp`) and the
checkpointed steps (`remat`), each against its JAX twin.

Tolerances: outputs 1e-5 of their scale; gradients 1e-4 of each one's
scale (float32; the hand-written backward sums the weight gradients over
the stacked steps in another order than the loop)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparrowrecsys_torch.ops import augru as T
from sparrowrecsys_tpu.ops import augru as J

torch.set_num_threads(2)

B, STEPS, D, H = 12, 5, 4, 3
MODES = {"autodiff": {}, "custom_vjp": {"custom_vjp": True}, "remat": {"remat": True}}


def _close(got, ref, rel, what):
    ref = np.asarray(ref)
    scale = max(np.abs(ref).max(), 1e-6)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=rel * scale, err_msg=what)


def _inputs(seed, masked):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=0.5: (rng.normal(size=s) * sc).astype(np.float32)  # noqa: E731
    mask = rng.random((B, STEPS)) < 0.7 if masked else None
    if masked:
        mask[0] = False                              # a row with no live step
        mask[1, 0] = False                           # a masked first step
    gru = dict(kernel=f(D, 3 * H), recurrent=f(H, 3 * H), bias=f(3 * H, sc=0.1))
    aug = {g: dict(w=f(H, H), b=f(H, sc=0.1), u=f(H, H)) for g in "rzh"}
    return dict(x=f(B, STEPS, D, sc=1.0), mask=mask, gru=gru, aug=aug,
                att=rng.random((B, STEPS, H)).astype(np.float32),
                g_hs=f(B, STEPS, H, sc=1.0), g_fin=f(B, H, sc=1.0))


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("mode", MODES)
def test_gru_matches_jax(mode, masked):
    a = _inputs(0, masked)

    def jfn(x, kernel, recurrent, bias):
        hs = J.gru(J.GRUParams(kernel, recurrent, bias), x,
                   None if a["mask"] is None else jnp.asarray(a["mask"]), **MODES[mode])
        return jnp.sum(hs * a["g_hs"]), hs

    args = [a["x"], a["gru"]["kernel"], a["gru"]["recurrent"], a["gru"]["bias"]]
    (_, ref), ref_grads = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3), has_aux=True)(
        *map(jnp.asarray, args))

    ts = [torch.from_numpy(v).requires_grad_() for v in args]
    mask = None if a["mask"] is None else torch.from_numpy(a["mask"])
    hs = T.gru(T.GRUParams(*ts[1:]), ts[0], mask, **MODES[mode])
    grads = torch.autograd.grad((hs * torch.from_numpy(a["g_hs"])).sum(), ts)
    _close(hs.detach(), ref, 1e-5, "hs")
    for name, g, r in zip(("x", "kernel", "recurrent", "bias"), grads, ref_grads):
        _close(g, r, 1e-4, name)
    if masked:
        assert not hs[0].detach().any()              # no live step: h stays at h0 = 0


@pytest.mark.parametrize("mode", MODES)
def test_augru_matches_jax(mode):
    a = _inputs(1, False)
    names = [f"{g}_{p}" for g in "rzh" for p in "wbu"]
    flat = [a["aug"][n[0]][n[2]] for n in names]

    def jfn(states, att, *w):
        p = J.AUGRUParams(*(J.AUGRUGate(*w[3 * i:3 * i + 3]) for i in range(3)))
        h = J.augru(p, states, att, **MODES[mode])
        return jnp.sum(h * a["g_fin"]), h

    states = np.tanh(a["x"][..., :H])
    args = [states, a["att"]] + flat
    (_, ref), ref_grads = jax.value_and_grad(
        jfn, argnums=tuple(range(len(args))), has_aux=True)(*map(jnp.asarray, args))

    ts = [torch.from_numpy(np.ascontiguousarray(v)).requires_grad_() for v in args]
    p = T.AUGRUParams(*(T.AUGRUGate(*ts[2 + 3 * i:5 + 3 * i]) for i in range(3)))
    h = T.augru(p, ts[0], ts[1], **MODES[mode])
    grads = torch.autograd.grad((h * torch.from_numpy(a["g_fin"])).sum(), ts)
    _close(h.detach(), ref, 1e-5, "h")
    for name, g, r in zip(["states", "att"] + names, grads, ref_grads):
        _close(g, r, 1e-4, name)


def test_augru_takes_a_broadcast_attention():
    """DIEN hands the AUGRU its [B, T, 1] attention expanded over H; the
    attention's gradient then sums over H, as JAX's broadcast_to does."""
    a = _inputs(2, False)
    states = torch.from_numpy(np.tanh(a["x"][..., :H]))
    p = T.AUGRUParams(*(T.AUGRUGate(*(torch.from_numpy(a["aug"][g][k]) for k in "wbu"))
                        for g in "rzh"))
    att = torch.from_numpy(a["att"][..., :1]).requires_grad_()
    grads = []
    for mode in MODES.values():
        h = T.augru(p, states, att.expand(B, STEPS, H), **mode)
        grads.append(torch.autograd.grad(h.sum(), att)[0])
    for g in grads[1:]:
        np.testing.assert_allclose(g, grads[0], rtol=1e-5, atol=1e-6)
    assert grads[0].shape == (B, STEPS, 1)


def test_gru_takes_bfloat16_inputs_and_keeps_a_float32_state():
    a = _inputs(3, True)
    p = T.GRUParams(*(torch.from_numpy(a["gru"][k]) for k in ("kernel", "recurrent", "bias")))
    x = torch.from_numpy(a["x"]).to(torch.bfloat16)
    hs = T.gru(p, x, torch.from_numpy(a["mask"]))
    ref = J.gru(J.GRUParams(*(jnp.asarray(a["gru"][k]) for k in ("kernel", "recurrent", "bias"))),
                jnp.asarray(a["x"]).astype(jnp.bfloat16), jnp.asarray(a["mask"]))
    assert hs.dtype == torch.float32
    _close(hs, ref, 1e-5, "hs")


@pytest.mark.parametrize("fn", ["gru", "augru"])
def test_custom_vjp_with_remat_raises(fn):
    a = _inputs(4, False)
    with pytest.raises(ValueError, match="mutually exclusive"):
        if fn == "gru":
            T.gru(T.GRUParams(*(torch.from_numpy(a["gru"][k])
                                for k in ("kernel", "recurrent", "bias"))),
                  torch.from_numpy(a["x"]), custom_vjp=True, remat=True)
        else:
            p = T.AUGRUParams(*(T.AUGRUGate(*(torch.from_numpy(a["aug"][g][k]) for k in "wbu"))
                                for g in "rzh"))
            states = torch.from_numpy(a["x"][..., :H].copy())
            T.augru(p, states, torch.from_numpy(a["att"]), custom_vjp=True, remat=True)

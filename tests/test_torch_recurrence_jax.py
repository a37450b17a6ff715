"""DIEN's recurrences on the kernels' path held against the JAX package's
`gru` and `augru` (`sparrowrecsys_tpu/ops/augru.py`) on the same inputs:
the outputs and the gradients of a fixed projection of them for every
input and weight, through `_GRUKernel` and `_AUGRUKernel` (the port's
`gru` and `augru` whole, input projections included).

The card's machine has no JAX, so JAX's outputs and gradients are kept
in `tests/recurrence_jax.npz` with the inputs they were computed from,
at H = 10 (DIEN's width, with an all-masked row and masked first and
last steps) and H = 32 (the kernels' widest). On the CPU one test
recomputes them with JAX and holds the file to them, and the Functions
run on the kernels' twins (`_KERNEL_DEVICES` patched to take CPU
tensors); on the card (`cuda` marker) the Functions launch the kernels:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_recurrence_jax.py

Regenerate the file with `JAX_PLATFORMS=cpu python -m tests.test_torch_recurrence_jax`.

Tolerances (float32), as `test_torch_augru.py` holds the plain path to
JAX: outputs 1e-5 of their scale, gradients 1e-4 of each one's scale;
JAX's scan and the kernels sum each product and the weight gradients in
other orders. The file against a fresh JAX run: 1e-6 of the scale, room
for another JAX build's rounding.
"""

import os

import numpy as np
import pytest
import torch

from sparrowrecsys_torch.ops import augru as A

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "recurrence_jax.npz")
CASES = {"h10": (37, 9, 10), "h32": (21, 6, 32)}
GRU_IN = ("x", "kernel", "recurrent", "bias")
AUGRU_IN = ("states", "att") + tuple(f"{g}_{p}" for g in "rzh" for p in "wbu")
OUT_TOL, GRAD_TOL, FILE_TOL = 1e-5, 1e-4, 1e-6


def make_inputs(case):
    """The inputs of one case, from a fixed seed: x [B, T, H] and the GRU's
    weights, its mask, the AUGRU's states [B, T, H], a [B, T, 1]
    attention and weights, and the projections' cotangents."""
    b, t, h = CASES[case]
    rng = np.random.default_rng(h)
    f = lambda *s, sc=0.5: (rng.normal(size=s) * sc).astype(np.float32)  # noqa: E731
    mask = rng.random((b, t)) < 0.8
    mask[0] = False                                  # a row with no live step
    mask[1, 0] = mask[2, -1] = False                 # masked first and last steps
    out = dict(x=f(b, t, h, sc=1.0), kernel=f(h, 3 * h), recurrent=f(h, 3 * h),
               bias=f(3 * h, sc=0.1), mask=mask, states=np.tanh(f(b, t, h, sc=1.0)),
               att=rng.random((b, t, 1)).astype(np.float32),
               g_hs=f(b, t, h, sc=1.0), g_fin=f(b, h, sc=1.0))
    for g in "rzh":
        out.update({f"{g}_w": f(h, h), f"{g}_b": f(h, sc=0.1), f"{g}_u": f(h, h)})
    return out


def jax_readings(a):
    """JAX's hs and h_final, and the gradients of sum(hs * g_hs) and of
    sum(h_final * g_fin), by name ("gru.x", "augru.att", ...)."""
    import jax
    import jax.numpy as jnp

    from sparrowrecsys_tpu.ops import augru as J

    h = a["x"].shape[-1]

    def gru_fn(x, kernel, recurrent, bias):
        hs = J.gru(J.GRUParams(kernel, recurrent, bias), x, jnp.asarray(a["mask"]))
        return jnp.sum(hs * a["g_hs"]), hs

    def augru_fn(states, att, *w):
        p = J.AUGRUParams(*(J.AUGRUGate(*w[3 * i:3 * i + 3]) for i in range(3)))
        hf = J.augru(p, states, jnp.broadcast_to(att, states.shape[:2] + (h,)))
        return jnp.sum(hf * a["g_fin"]), hf

    out = {}
    for name, fn, names in (("gru", gru_fn, GRU_IN), ("augru", augru_fn, AUGRU_IN)):
        (_, y), grads = jax.value_and_grad(fn, argnums=tuple(range(len(names))), has_aux=True)(
            *(jnp.asarray(a[k]) for k in names))
        out[f"{name}.out"] = np.asarray(y)
        out.update({f"{name}.{k}": np.asarray(g) for k, g in zip(names, grads)})
    return out


def load(case):
    """(inputs, JAX's readings) of one case, from the file."""
    with np.load(FIXTURE) as z:
        got = {k.split("/", 1)[1]: z[k] for k in z.files if k.startswith(case + "/")}
    return ({k: v for k, v in got.items() if "." not in k},
            {k: v for k, v in got.items() if "." in k})


def write_fixture(path=FIXTURE):
    arrays = {}
    for case in CASES:
        a = make_inputs(case)
        arrays.update({f"{case}/{k}": v for k, v in {**a, **jax_readings(a)}.items()})
    np.savez_compressed(path, **arrays)


def _close(got, ref, rel, what):
    got, ref = got.detach().double().cpu().numpy(), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, f"{what}: shape {got.shape} against {ref.shape}"
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, f"{what}: max error {err} against {rel} of {scale}"


def port_readings(a, device):
    """The port's readings of `jax_readings`, with the autograd node each
    output came from."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in a.items()}
    leaves = {k: t[k].clone().requires_grad_() for k in GRU_IN + AUGRU_IN}
    hs = A.gru(A.GRUParams(*(leaves[k] for k in GRU_IN[1:])), leaves["x"], t["mask"])
    gates = [A.AUGRUGate(*(leaves[f"{g}_{p}"] for p in "wbu")) for g in "rzh"]
    hf = A.augru(A.AUGRUParams(*gates), leaves["states"], leaves["att"])
    out = {"gru.out": hs, "augru.out": hf}
    out.update({f"gru.{k}": g for k, g in zip(
        GRU_IN, torch.autograd.grad((hs * t["g_hs"]).sum(), [leaves[k] for k in GRU_IN]))})
    out.update({f"augru.{k}": g for k, g in zip(
        AUGRU_IN, torch.autograd.grad((hf * t["g_fin"]).sum(), [leaves[k] for k in AUGRU_IN]))})
    return out, (type(hs.grad_fn).__name__, type(hf.grad_fn).__name__)


def _check(case, device):
    a, ref = load(case)
    got, nodes = port_readings(a, device)
    assert nodes == ("_GRUKernelBackward", "_AUGRUKernelBackward")
    assert set(got) == set(ref)
    for k, r in ref.items():
        _close(got[k], r, OUT_TOL if k.endswith(".out") else GRAD_TOL, f"{case} {k}")
    assert not got["gru.out"][0].any()               # no live step: h stays at h0 = 0


@pytest.mark.parametrize("case", CASES)
def test_file_holds_jaxs_readings_of_its_inputs(case):
    a, ref = load(case)
    for k, v in make_inputs(case).items():
        np.testing.assert_array_equal(a[k], v, err_msg=k)
    fresh = jax_readings(a)
    assert set(fresh) == set(ref)
    for k, r in ref.items():
        _close(torch.from_numpy(r), fresh[k], FILE_TOL, f"{case} {k}")


@pytest.mark.parametrize("case", CASES)
def test_twins_path_matches_jax(case, monkeypatch):
    """The Functions on the CPU, where their wrappers run the twins."""
    monkeypatch.setattr(A, "_KERNEL_DEVICES", ("cuda", "cpu"))
    _check(case, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kernels_match_jax(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    names = ("gru_scan_fwd", "gru_scan_bwd", "augru_scan_fwd", "augru_scan_bwd")
    before = {n: getattr(A, n).launches for n in names}
    _check(case, "cuda")
    assert {n: getattr(A, n).launches - before[n] for n in names} == dict.fromkeys(names, 1)


if __name__ == "__main__":
    write_fixture()
    print(f"wrote {FIXTURE}")

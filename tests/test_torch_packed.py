"""`ops/embedding.py::packed_multi_lookup` and
`models/features.py::packed_embed_bias` in the port against the JAX
package's, on the same numpy tables and ids (-1, 0 and ids past V
included). Forwards bit-equal; each table's gradient within 1e-6 of its
largest magnitude (JAX sums a table's rows by a one-hot product at
V <= 2048 and a scatter-add above, the port by autograd's scatter-add:
other float32 summation orders, up to 64 terms a row here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparrowrecsys_torch.models.features import merged_embed_bias, packed_embed_bias
from sparrowrecsys_torch.ops.embedding import embed_lookup, packed_multi_lookup
from sparrowrecsys_tpu.models.features import packed_embed_bias as jax_packed_embed_bias
from sparrowrecsys_tpu.ops.embedding import packed_multi_lookup as jax_packed_multi_lookup

torch.set_num_threads(2)


def _loss_torch(outs):
    return sum(torch.sin(o).sum() for o in outs)


def _loss_jax(outs):
    return sum(jnp.sum(jnp.sin(o)) for o in outs)


def _assert_grad_close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("lo", [None, (0, 0, 1)], ids=["default_lo", "mask_zero_column"])
def test_packed_multi_lookup_matches_jax(lo):
    rng = np.random.default_rng(0)
    vocab = (11, 3000, 5)          # both sides of the one-hot gradient's 2048
    tables = [rng.normal(size=(v, 6)).astype(np.float32) for v in vocab]
    ids = [rng.integers(-2, v + 2, 64).astype(np.int32) for v in vocab]
    for i in ids:
        i[:3] = (0, -1, 1)

    ref = jax_packed_multi_lookup([jnp.asarray(t) for t in tables],
                                  [jnp.asarray(i) for i in ids], lo)
    tt = [torch.from_numpy(t).requires_grad_() for t in tables]
    ti = [torch.from_numpy(i) for i in ids]
    got = packed_multi_lookup(tt, ti, lo)
    for k, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(r))
        one = embed_lookup(tt[k], ti[k], mask_zero=bool(lo and lo[k] == 1))
        assert torch.equal(g, one)

    jgrads = jax.grad(lambda ts: _loss_jax(jax_packed_multi_lookup(
        ts, [jnp.asarray(i) for i in ids], lo)))([jnp.asarray(t) for t in tables])
    tgrads = torch.autograd.grad(_loss_torch(got), tt)
    for g, r in zip(tgrads, jgrads):
        _assert_grad_close(g, r)


def test_packed_embed_bias_matches_jax():
    rng = np.random.default_rng(1)
    cols = []
    for v in (1001, 30001, 19, 19):
        cols.append((rng.normal(size=(v, 10)).astype(np.float32),
                     rng.normal(size=(v, 1)).astype(np.float32),
                     rng.integers(-1, v + 1, 64).astype(np.int32)))
    jcols = [tuple(jnp.asarray(x) for x in c) for c in cols]
    ref = jax_packed_embed_bias(jcols)
    tcols = [(torch.from_numpy(e).requires_grad_(), torch.from_numpy(b).requires_grad_(),
              torch.from_numpy(i)) for e, b, i in cols]
    got = packed_embed_bias(tcols)
    for (ge, gb), (re, rb), (e, b, i) in zip(got, ref, tcols):
        np.testing.assert_array_equal(ge.detach().numpy(), np.asarray(re))
        np.testing.assert_array_equal(gb.detach().numpy(), np.asarray(rb))
        me, mb = merged_embed_bias(e, b, i)
        assert torch.equal(ge, me) and torch.equal(gb, mb)

    def jloss(tabs):
        outs = jax_packed_embed_bias([(e, b, c[2]) for (e, b), c in zip(tabs, jcols)])
        return _loss_jax([o for pair in outs for o in pair])

    jgrads = jax.grad(jloss)([(c[0], c[1]) for c in jcols])
    leaves = [x for e, b, _ in tcols for x in (e, b)]
    tgrads = torch.autograd.grad(_loss_torch([o for pair in got for o in pair]), leaves)
    for g, r in zip(tgrads, [x for pair in jgrads for x in pair]):
        _assert_grad_close(g, r)

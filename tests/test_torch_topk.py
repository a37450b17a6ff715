"""The port's top-k (`sparrowrecsys_torch/ops/topk.py`) against the JAX
package's on the CPU: `lax.top_k`'s order on tied scores (equal scores in
ascending index order: zero rows, duplicate rows, the signed zeros), the
prepared catalog, and the dispatch policy off the TPU.

Tolerances: indices equal; scores within 1e-6 (float32 cosines from two
matmuls); the bfloat16-resident catalog keeps recall@10 against float32
at or above 0.9 (the measured figure is printed)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparrowrecsys_torch.ops import topk as T
from sparrowrecsys_tpu.ops import topk as J


def _both(queries, items, k):
    js, ji = J.cosine_topk(jnp.asarray(queries), jnp.asarray(items), k)
    ts, ti = T.cosine_topk(torch.from_numpy(queries), torch.from_numpy(items), k)
    return np.asarray(js), np.asarray(ji), ts.numpy(), ti.numpy()


def test_top_k_ties_take_the_lowest_index_first():
    """The 7-item case: `torch.topk` alone gives [5, 4, 1, 6]."""
    s = np.array([[0, 1, 1, 0, 1, 1, 1]], np.float32)
    _, idx = T.top_k(torch.from_numpy(s), 4)
    assert idx.tolist() == [[1, 2, 4, 5]]
    assert idx.tolist() == np.asarray(jax.lax.top_k(s, 4)[1]).tolist()


def test_top_k_ties_over_5000_items():
    s = np.zeros((1, 5000), np.float32)
    s[0, 2500:2505] = 1.0
    _, idx = T.top_k(torch.from_numpy(s), 5)
    assert idx.tolist() == [[2500, 2501, 2502, 2503, 2504]]


def test_top_k_matches_lax_on_random_ties_and_signed_zeros():
    rng = np.random.default_rng(0)
    for _ in range(200):
        q, m = int(rng.integers(1, 5)), int(rng.integers(1, 80))
        k = int(rng.integers(1, m + 1))
        s = (rng.integers(-3, 3, (q, m)) / 2).astype(np.float32)
        zeros = s == 0
        s[zeros] = rng.choice(np.array([0.0, -0.0], np.float32), size=zeros.sum())
        jv, ji = jax.lax.top_k(s, k)
        tv, ti = T.top_k(torch.from_numpy(s), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy().view(np.int32), np.asarray(jv).view(np.int32))


@pytest.mark.parametrize("case", ["zero_rows", "duplicate_rows", "both"])
def test_cosine_topk_ties_match_jax(case):
    rng = np.random.default_rng(1)
    items = rng.normal(size=(300, 8)).astype(np.float32)
    if case in ("zero_rows", "both"):
        items[rng.choice(300, 60, replace=False)] = 0.0    # cold items: score 0
    if case in ("duplicate_rows", "both"):
        items[200:260] = items[7]                          # one vector, 61 rows
    queries = np.concatenate([items[[7, 11]], rng.normal(size=(6, 8))]).astype(np.float32)
    k = 150                                                # into the tied blocks
    js, ji, ts, ti = _both(queries, items, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)


def test_prepared_float32_equals_unprepared_and_jax():
    rng = np.random.default_rng(2)
    items = rng.normal(size=(2000, 16)).astype(np.float32)
    queries = rng.normal(size=(32, 16)).astype(np.float32)
    prep = T.prepare_catalog(torch.from_numpy(items))
    assert prep.dtype == torch.float32 and prep.shape == (2000, 16)
    ps, pi = T.cosine_topk_prepared(torch.from_numpy(queries), prep, 10)
    us, ui = T.cosine_topk(torch.from_numpy(queries), torch.from_numpy(items), 10)
    np.testing.assert_array_equal(pi.numpy(), ui.numpy())
    np.testing.assert_array_equal(ps.numpy(), us.numpy())
    js, ji = J.cosine_topk_prepared(jnp.asarray(queries), J.prepare_catalog(jnp.asarray(items)), 10)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=0, atol=1e-6)


def test_prepared_bfloat16_recall_and_float32_scores():
    rng = np.random.default_rng(3)
    items = torch.from_numpy(rng.normal(size=(4000, 32)).astype(np.float32))
    queries = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32))
    exact = T.cosine_topk_prepared(queries, T.prepare_catalog(items), 10)[1]
    prep = T.prepare_catalog(items, dtype=torch.bfloat16)
    assert prep.dtype == torch.bfloat16
    s, i = T.cosine_topk_prepared(queries, prep, 10)
    assert s.dtype == torch.float32
    recall = np.mean([len(set(a) & set(b)) / 10
                      for a, b in zip(i.tolist(), exact.tolist())])
    print(f"bf16 recall@10 against float32: {recall:.4f}")
    assert recall >= 0.9, recall
    jprep = J.prepare_catalog(jnp.asarray(items.numpy()), jnp.bfloat16)
    _, ji = J.cosine_topk_prepared(jnp.asarray(queries.numpy()), jprep, 10)
    jrecall = np.mean([len(set(a) & set(b)) / 10
                       for a, b in zip(np.asarray(ji).tolist(), exact.tolist())])
    assert abs(recall - jrecall) <= 0.05, (recall, jrecall)


def test_prepared_refuses_a_raw_tensor():
    with pytest.raises(TypeError):
        T.cosine_topk_prepared(torch.ones(2, 4), torch.ones(5, 4), 2)


@pytest.mark.parametrize("n", [10, J.APPROX_TOPK_MIN_ITEMS, 10 ** 7])
def test_dispatch_is_exact_off_the_tpu(n):
    assert T.topk_dispatch(n) == "exact"
    assert T.topk_dispatch(n) == J.topk_dispatch(n)  # the JAX package on its CPU backend
    rng = np.random.default_rng(4)
    items = torch.from_numpy(rng.normal(size=(50, 4)).astype(np.float32))
    queries = items[:3]
    want = T.cosine_topk(queries, items, 5)
    for got in (T.cosine_topk_auto(queries, items, 5), T.cosine_topk_approx(queries, items, 5)):
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])

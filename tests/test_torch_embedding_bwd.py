"""The small-table embedding backward's plain twin, its plan and its
dispatch, on the CPU.

`ops/embedding.py::embedding_bwd_plain` is held against the JAX package's
one-hot product (`_gather_oh_bwd`, the backward the JAX package runs for a
table of V <= 2048) and against PyTorch's `embedding_dense_backward` (the
parent's backward, after the mask's `where`) on the same inputs. The
kernel itself runs only on the card (tests/test_torch_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparrowrecsys_torch.models.din import DIN
from sparrowrecsys_torch.ops import embedding as emb
from sparrowrecsys_torch.ops import kernels
from sparrowrecsys_torch.ops.embedding import (
    BWD_WARPS,
    H100_SMS,
    MAX_DIM,
    MAX_TABLE_BYTES,
    SMEM_LIMIT,
    bwd_fits,
    bwd_plan,
    bwd_smem,
    embed_lookup,
    embedding_bwd,
    embedding_bwd_plain,
    takes_kernel,
)
from sparrowrecsys_torch.training.loop import Trainer
from sparrowrecsys_tpu.ops import embedding as jax_embedding

torch.set_num_threads(2)


def _zipf(rng, n, lo, hi, s=1.0):
    """n ids in [lo, hi), id lo + r - 1 with probability ~ 1 / r^s."""
    p = 1.0 / np.arange(1, hi - lo + 1) ** s
    return lo + rng.choice(hi - lo, size=n, p=p / p.sum())


def _references(g, ids, v, lo):
    """(JAX's one-hot product on the masked gradient, the parent's
    backward: the mask's `where`, then `embedding_dense_backward` on the
    clamped ids), both [V, D] as numpy."""
    d = g.shape[-1]
    valid = (ids >= lo) & (ids < v)
    gm = np.where(valid[..., None], g, 0.0).astype(np.float32)
    safe = np.clip(ids, 0, v - 1)
    if ids.size:
        one_hot = np.asarray(jax_embedding._gather_oh_bwd(
            (jnp.asarray(safe.astype(np.int32)), v), jnp.asarray(gm.reshape(-1, d)))[0])
    else:  # its reshape cannot infer the width of no rows; their sum is 0
        one_hot = np.zeros((v, d), np.float32)
    dense = torch.ops.aten.embedding_dense_backward(
        torch.from_numpy(gm), torch.from_numpy(safe).long(), v, -1, False).numpy()
    return one_hot, dense


#: (name, ids shape, V, D, lo, id dtype, how the ids are drawn).
CASES = [
    ("history_lo1", (64, 9), 1001, 10, 1, np.int32, "zipf_pad"),
    ("genre_lo0", (700,), 19, 10, 0, np.int32, "uniform"),
    ("int64_ids", (300, 5), 1001, 11, 0, np.int64, "uniform"),
    ("pad_and_oov_mixed", (50, 40), 200, 4, 1, np.int64, "mixed"),
    # 20,000 rows split 1 tile a block: the head id (about 22% of the rows
    # over 50 ids) spans dozens of blocks.
    ("zipf_head_over_blocks", (20000,), 50, 3, 1, np.int32, "zipf"),
    ("no_rows", (0,), 1001, 10, 1, np.int32, "uniform"),
    ("budget_edge", (2000,), 1024, 16, 0, np.int32, "uniform"),
    ("bias_column", (4000,), 1001, 1, 0, np.int32, "uniform"),
]


def _case_inputs(shape, v, d, lo, dtype, draw, seed=0):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    if draw == "uniform":
        ids = rng.integers(-1, v + 2, size=n)
    elif draw == "zipf":
        ids = _zipf(rng, n, lo, v)
    elif draw == "zipf_pad":
        ids = np.where(rng.random(n) < 0.2, 0, _zipf(rng, n, 1, v))
    else:  # every kind of id: pad 0, -1, >= V, far out of range, and Zipf
        ids = np.where(rng.random(n) < 0.5, _zipf(rng, n, 0, v),
                       rng.choice([0, -1, v, v + 7, -5, 2 ** 31 - 1], size=n))
    g = rng.normal(size=shape + (d,)).astype(np.float32)
    return g, ids.reshape(shape).astype(dtype)


@pytest.mark.parametrize("name,shape,v,d,lo,dtype,draw", CASES, ids=[c[0] for c in CASES])
def test_twin_matches_the_one_hot_product_and_the_dense_backward(name, shape, v, d, lo, dtype,
                                                                 draw):
    g, ids = _case_inputs(shape, v, d, lo, dtype, draw)
    got = embedding_bwd_plain(torch.from_numpy(g), torch.from_numpy(ids), v, lo).numpy()
    one_hot, dense = _references(g, ids, v, lo)
    assert got.shape == (v, d) and got.dtype == np.float32
    # float32 sums in another order: a few ulps of the cell's sum of |g|.
    scale = np.zeros((v, d), np.float64)
    valid = (ids >= lo) & (ids < v)
    np.add.at(scale, ids[valid].astype(np.int64), np.abs(g[valid]))
    for ref in (one_hot, dense):
        assert np.all(np.abs(got - ref) <= 1e-6 * scale + 1e-30)
    if lo:
        assert not got[0].any()                  # the pad id's row gets nothing


def test_twin_repeats_the_kernels_block_split():
    """The twin sums block by block in the plan's split: its result is the
    blocks' partials (each an index_add_ of the block's kept rows) added
    in block order, bit for bit."""
    g, ids = _case_inputs((20000,), 50, 3, 1, np.int32, "zipf", seed=4)
    tg, ti = torch.from_numpy(g), torch.from_numpy(ids)
    plan = bwd_plan(20000, 50, 3, 4)
    assert plan.grid > 10
    want = torch.zeros(50, 3)
    for b in range(plan.grid):
        part = torch.zeros(50, 3)
        for r in range(b * plan.rows_per_block, min(20000, (b + 1) * plan.rows_per_block)):
            if 1 <= ids[r] < 50:
                part[ids[r]] += tg[r]
        want += part
    assert torch.equal(embedding_bwd_plain(tg, ti, 50, 1), want)


@pytest.mark.parametrize("v,d", [(1001, 10), (1001, 11), (19, 10), (1001, 1), (1024, 16),
                                 (16384, 1), (64, MAX_DIM), (1, MAX_DIM), (1, 1)])
@pytest.mark.parametrize("id_bytes", [4, 8])
def test_plan_fits_shared_memory_and_covers_the_rows(v, d, id_bytes):
    """The rules the C entry point checks: the copies divide the block's
    warps, a tile is whole chunks of every copy, whole tiles a block, every
    row in exactly one of at most H100_SMS blocks, and the shared memory
    (copies of the table beside three tiles) within the H100's limit."""
    assert bwd_fits(v, d)
    for n in (0, 1, 31, 383, 385, 131072, 131072 * 65):
        p = bwd_plan(n, v, d, id_bytes)
        assert BWD_WARPS % p.copies == 0 and p.copies * p.warps_per_copy == BWD_WARPS
        assert p.tile_rows % (32 * p.copies) == 0 and p.rows_per_block % p.tile_rows == 0
        assert p.smem_bytes == bwd_smem(v, d, id_bytes, p.copies, p.tile_rows) <= SMEM_LIMIT
        assert (p.grid == 0) == (n == 0) and p.grid <= H100_SMS
        assert p.grid * p.rows_per_block >= n > (p.grid - 1) * p.rows_per_block or n == 0


def test_plan_at_the_cells_shape():
    """DIN's movie lookup: four copies of the 40 KB table, two warps a copy,
    tiles of 384 rows, one block per SM."""
    p = bwd_plan(131072 * 65, 1001, 10, 4)
    assert (p.copies, p.warps_per_copy, p.tile_rows, p.grid) == (4, 2, 384, 132)


def test_budget_edges():
    assert bwd_fits(1024, 16) and 1024 * 16 * 4 == MAX_TABLE_BYTES
    assert not bwd_fits(1025, 16) and not bwd_fits(30001, 10)
    assert bwd_fits(64, MAX_DIM) and not bwd_fits(32, MAX_DIM + 1)
    with pytest.raises(ValueError, match="budget"):
        embedding_bwd(torch.zeros(4, 10), torch.zeros(4, dtype=torch.int32), 30001, 0)


def test_wrapper_refuses_tensors_neither_on_the_cpu_nor_on_a_card():
    with pytest.raises(ValueError, match="g on meta"):
        embedding_bwd(torch.zeros(4, 10, device="meta"),
                      torch.zeros(4, dtype=torch.int32, device="meta"), 1001, 0)


def test_wrapper_on_the_cpu_is_the_twin_and_launches_nothing():
    g, ids = _case_inputs((300,), 1001, 10, 0, np.int32, "uniform")
    before = kernels.launch_counts()
    got = embedding_bwd(torch.from_numpy(g), torch.from_numpy(ids), 1001, 0)
    assert kernels.launch_counts() == before
    assert torch.equal(got, embedding_bwd_plain(torch.from_numpy(g), torch.from_numpy(ids),
                                                1001, 0))


@pytest.fixture
def cpu_takes_kernel(monkeypatch):
    """Lets CPU tables take the kernel's path, whose backward on the CPU is
    the twin: the dispatch and the Function run as they do on the card."""
    monkeypatch.setattr(emb, "_KERNEL_DEVICES", ("cuda", "cpu"))


def _grad_fn(out):
    return type(out.grad_fn).__name__ if out.grad_fn is not None else None


@pytest.mark.parametrize("v,d,dtype,grad,takes", [
    (1001, 10, torch.float32, True, True),      # DIN's and DIEN's movie table
    (1001, 11, torch.float32, True, True),      # DeepFM's merged movie table and bias
    (19, 10, torch.float32, True, True),        # a genre table
    (1001, 1, torch.float32, True, True),       # a bias column
    (30001, 10, torch.float32, True, False),    # the user table
    (1001, 10, torch.bfloat16, True, False),    # a bfloat16 cast
    (1001, 10, torch.float32, False, False),    # serving: no gradient
], ids=["movie", "merged_movie", "genre", "bias", "user", "bf16", "no_grad"])
def test_dispatch_by_shape_dtype_and_grad(cpu_takes_kernel, v, d, dtype, grad, takes):
    table = torch.randn(v, d).to(dtype).requires_grad_()
    ids = torch.randint(-1, v + 1, (16, 4), dtype=torch.int32)
    with torch.set_grad_enabled(grad):
        assert takes_kernel(table, ids) == takes
        out = embed_lookup(table, ids, mask_zero=True)
    assert (_grad_fn(out) == "_MaskedLookupBackward") == takes
    if not grad:
        assert out.grad_fn is None                  # no autograd node under no_grad


def test_cpu_tables_keep_the_parents_ops():
    table = torch.randn(1001, 10, requires_grad=True)
    ids = torch.randint(-1, 1002, (16, 4), dtype=torch.int32)
    assert not takes_kernel(table, ids)
    assert _grad_fn(embed_lookup(table, ids)) == "WhereBackward0"
    assert not takes_kernel(table, ids.to(torch.int16))


@pytest.mark.parametrize("mask_zero", [False, True])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_function_gives_the_parents_values_and_gradients(cpu_takes_kernel, mask_zero, id_dtype):
    """The Function's forward is the parent's ops (bit-equal); its backward
    (the twin on the raw ids) is the parent's gradient to float32 rounding."""
    gen = torch.Generator().manual_seed(3)
    table = torch.randn(1001, 10, generator=gen)
    ids = torch.randint(-2, 1004, (256, 9), generator=gen).to(id_dtype)
    ids[0, :4] = torch.tensor([0, -1, 1001, 1000])
    w = torch.randn(256, 9, 10, generator=gen)
    grads, outs = [], []
    for kernel_path in (False, True):
        t = table.clone().requires_grad_()
        if kernel_path:
            out = embed_lookup(t, ids, mask_zero=mask_zero)
            assert _grad_fn(out) == "_MaskedLookupBackward"
        else:
            out = emb._masked_gather(t, ids, 1 if mask_zero else 0)
        (out * w).sum().backward()
        outs.append(out.detach())
        grads.append(t.grad)
    assert torch.equal(outs[0], outs[1])
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-6, atol=1e-6)


def test_tiny_din_gradients_equal_the_parents_path(monkeypatch):
    """A tiny DIN's `loss_and_grads` on the CPU: with the movie and genre
    lookups on the kernel's path (the twin's backward), every gradient
    equals the parent's path's to float32 rounding; the user table's
    lookup keeps the parent's backward either way."""
    rng = np.random.default_rng(7)
    b, t = 64, 5
    feats = {"movieId": _zipf(rng, b, 1, 1001), "userId": rng.integers(0, 30001, b),
             "userGenre1": rng.integers(-1, 19, b), "movieGenre1": rng.integers(-1, 19, b)}
    for k in range(t):
        feats[f"userRatedMovie{k + 1}"] = np.where(rng.random(b) < 0.3, 0,
                                                   _zipf(rng, b, 1, 1001))
    feats = {k: torch.from_numpy(v.astype(np.int32)) for k, v in feats.items()}
    for c in ("userRatingCount", "userAvgRating", "userRatingStddev", "releaseYear",
              "movieRatingCount", "movieAvgRating", "movieRatingStddev"):
        feats[c] = torch.from_numpy(rng.normal(size=b).astype(np.float32))
    labels = torch.from_numpy((rng.random(b) < 0.5).astype(np.float32))
    torch.manual_seed(0)
    model = DIN(recent_movies=t, hidden=16)
    trainer = Trainer(model, device="cpu")
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    parent = trainer.loss_and_grads(params, None, feats, labels, torch.ones(b))
    monkeypatch.setattr(emb, "_KERNEL_DEVICES", ("cuda", "cpu"))
    seen = []
    real = emb._MaskedLookup.apply
    monkeypatch.setattr(emb._MaskedLookup, "apply",
                        lambda table, ids, lo: seen.append(tuple(table.shape)) or real(
                            table, ids, lo))
    kernel = trainer.loss_and_grads(params, None, feats, labels, torch.ones(b))
    assert sorted(seen) == [(19, 10), (19, 10), (1001, 10)]
    assert torch.equal(parent[1], kernel[1])                      # the same forward
    assert set(parent[3]) == set(kernel[3])
    for k, g in parent[3].items():
        torch.testing.assert_close(kernel[3][k], g, rtol=1e-5, atol=1e-7, msg=k)

"""The hand-written CUDA kernels against their plain PyTorch versions.

These run only on a CUDA card (a CUDA kernel has no CPU mode): every
kernel test carries the `cuda` marker and skips without one. The CPU tests
check the `fm_cross_bwd` tolerance itself, the row kernels' launch plan,
and the row wrappers' refusal of tensors on neither device. This file
imports no JAX, so the card's machine runs it without the JAX package's
conftest:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from sparrowrecsys_torch.ops.attention import (
    din_attention,
    din_attention_bwd,
    din_attention_bwd_plain,
    din_attention_plain,
)
from sparrowrecsys_torch.ops.fm import fm_cross, fm_cross_bwd, fm_cross_bwd_plain, fm_cross_plain
from sparrowrecsys_torch.ops.rowio import (
    MAX_GRID,
    ROWS_IN_FLIGHT,
    THREADS,
    WORDS,
    launch_plan,
    rows_gather,
    rows_gather_plain,
    rows_write,
    rows_write_plain,
)
from sparrowrecsys_torch.training.optim import grouped_adam
from sparrowrecsys_torch.training.row_optim import (
    _touched_rows,
    fused_row_adam_update,
    init_fused_row_adam,
)

from sparrowrecsys_torch.tools.kernel_bench import fm_bwd_tolerance, fm_cross_bwd_bf16_sum


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


#: DIN shapes of the card tests: the serving shape, small odd ones, the
#: shapes the first kernels refused (H=64 at D=128, T=256 at D=128, T=300,
#: H=24, H=100, D=512), the folded weight read through L1 (D=700) and the
#: step weights outside shared memory (T=9000).
DIN_SHAPES = [
    (8192, 5, 10, 32), (8, 8, 4, 8), (33, 130, 12, 16), (5, 1, 3, 64), (300, 64, 128, 32),
    (64, 5, 128, 64), (16, 256, 128, 32), (8, 300, 16, 32), (4, 5, 10, 24), (4, 5, 10, 100),
    (2, 5, 512, 64), (3, 4, 700, 12), (2, 9000, 4, 8),
]


def _din_inputs(b, t, d, h, device, seed=0):
    rng = np.random.default_rng(seed)
    hist = rng.normal(size=(b, t, d)).astype(np.float32)
    hist[:, t // 2:] = 0.0            # padded steps: all-zero rows
    hist[0, :] = 0.0                  # a row with no history at all
    hist[1, 0, 0] = 0.0               # a zero element alone does not mask
    arrays = [
        hist,
        rng.normal(size=(b, d)),
        rng.normal(size=(4 * d, h)) * 0.5,
        rng.normal(size=(h,)) * 0.1,
        rng.normal(size=(h,)) * 0.1,
        rng.normal(size=(h, 1)) * 0.5,
        rng.normal(size=(1,)) * 0.1,
    ]
    return [torch.from_numpy(np.asarray(a, np.float32)).to(device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape", [(8192, 5, 64), (100, 3, 10), (7, 5, 6), (0, 5, 8)])
def test_fm_cross_kernel_matches_plain(cuda_device, dtype, tol, shape):
    """float32: 1e-5 of the output's scale (summation order, one fma);
    bfloat16: 1e-2 (one rounding of the output)."""
    g = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(shape, generator=g).to(cuda_device, dtype)
    before = fm_cross.launches
    out = fm_cross(x)
    torch.cuda.synchronize()
    assert fm_cross.launches == before + (1 if shape[0] else 0)  # nothing to launch for B=0
    assert out.dtype == dtype and tuple(out.shape) == (shape[0], shape[2])
    ref = fm_cross_plain(x).float()
    scale = max(ref.abs().max().item(), 1.0) if ref.numel() else 1.0
    torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol * scale)


@pytest.mark.cuda
def test_fm_cross_kernel_on_unaligned_view(cuda_device):
    """A view 4 bytes off a 16-byte boundary takes the scalar path."""
    x = torch.randn(1 + 64 * 5 * 16, device=cuda_device)[1:].view(64, 5, 16)
    torch.testing.assert_close(fm_cross(x), fm_cross_plain(x), rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d,h", DIN_SHAPES)
def test_din_attention_kernel_matches_plain(cuda_device, b, t, d, h):
    """float32, another summation order than cuBLAS over 3D*H terms:
    1e-5 relative, and 1e-5 of the output's scale absolute."""
    args = _din_inputs(b, t, d, h, cuda_device)
    before = din_attention.launches
    out = din_attention(*args)
    torch.cuda.synchronize()
    assert din_attention.launches == before + 1
    ref = din_attention_plain(*args)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * max(1.0, ref.abs().max().item()))
    assert not out[0].any()


@pytest.mark.cuda
def test_din_attention_kernel_takes_bf16_history(cuda_device):
    args = _din_inputs(64, 5, 10, 32, cuda_device)
    bf = [args[0].bfloat16(), args[1].bfloat16()] + args[2:]
    out = din_attention(*bf)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, din_attention_plain(*bf), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    with pytest.raises(ValueError, match="dtype"):
        fm_cross(torch.zeros(4, 5, 8, device=cuda_device, dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        fm_cross(torch.zeros(4, 8, 5, device=cuda_device).transpose(1, 2))
    with pytest.raises(ValueError, match="dtype"):
        din_attention(*_din_inputs(4, 5, 10, 32, cuda_device)[:6],
                      torch.zeros(1, device=cuda_device, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        din_attention_bwd(*_din_inputs(4, 5, 10, 32, cuda_device),
                          torch.zeros(10, 4, device=cuda_device).t())
    # H=24, T=300 and D=512 with H=64, which the first kernels refused,
    # compute.
    for shape in ((4, 5, 10, 24), (4, 300, 10, 32), (2, 5, 512, 64)):
        args = _din_inputs(*shape, cuda_device)
        ref = din_attention_plain(*args)
        torch.testing.assert_close(din_attention(*args), ref, rtol=1e-5,
                                   atol=1e-5 * max(1.0, ref.abs().max().item()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fm_bwd_tolerance_passes_a_reordered_sum_and_fails_a_bf16_sum(dtype):
    """`fm_bwd_tolerance` (per element) holds s summed in float32 in
    another order, and rejects s kept in bfloat16."""
    g = torch.Generator(device="cpu").manual_seed(5)
    x = torch.randn(4096, 5, 64, generator=g).to(dtype)
    go = torch.randn(4096, 64, generator=g).to(dtype)
    ref = fm_cross_bwd_plain(x, go)
    tol = fm_bwd_tolerance(x, go, ref)
    xf = x.float()
    s = xf.flip(1).cumsum(1)[:, -1:]
    reordered = (2 * go.float()[:, None, :] * (s - xf)).to(dtype)
    assert bool(((reordered.float() - ref.float()).abs() <= tol).all())
    bf16_sum = fm_cross_bwd_bf16_sum(x.bfloat16(), go.bfloat16()).float()
    assert int(((bf16_sum - ref.float()).abs() > tol).sum()) > x.numel() // 100


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(65536, 5, 64), (100, 3, 10), (7, 5, 6), (0, 5, 8)])
def test_fm_cross_bwd_kernel_matches_plain(cuda_device, dtype, shape):
    """Per element within `fm_bwd_tolerance`: float32 roundings of s, and
    in bfloat16 one rounding of dx."""
    g = torch.Generator(device="cpu").manual_seed(1)
    x = torch.randn(shape, generator=g).to(cuda_device, dtype)
    go = torch.randn((shape[0], shape[2]), generator=g).to(cuda_device, dtype)
    before = fm_cross_bwd.launches
    dx = fm_cross_bwd(x, go)
    torch.cuda.synchronize()
    assert fm_cross_bwd.launches == before + (1 if shape[0] else 0)
    assert dx.dtype == dtype and dx.shape == x.shape
    ref = fm_cross_bwd_plain(x, go)
    assert bool(((dx.float() - ref.float()).abs() <= fm_bwd_tolerance(x, go, ref)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d,h", DIN_SHAPES)
def test_din_attention_bwd_kernel_matches_plain(cuda_device, b, t, d, h):
    """float32 sums over B*T in another order than cuBLAS: 1e-4 relative
    and 1e-4 of each gradient's scale absolute. Two runs agree bit for bit
    (the weight gradients are summed without atomics)."""
    args = _din_inputs(b, t, d, h, cuda_device)
    go = torch.randn(b, d, generator=torch.Generator(device="cpu").manual_seed(2)).to(cuda_device)
    before = din_attention_bwd.launches
    got = din_attention_bwd(*args, go)
    torch.cuda.synchronize()
    assert din_attention_bwd.launches == before + 1
    ref = din_attention_bwd_plain(*args, go)
    for name, x, r in zip(("dh", "dc", "dw1", "db1", "dalpha", "dw2", "db2"), got, ref):
        assert x.shape == r.shape, name
        scale = max(r.abs().max().item(), 1.0)
        torch.testing.assert_close(x, r, rtol=1e-4, atol=1e-4 * scale, msg=name)
    again = din_attention_bwd(*args, go)
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    assert not got[0][0].any() and not got[1][0].any()   # a row with no history


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_through_the_kernels_matches_plain_autograd(cuda_device, dtype):
    """Gradients through the wrappers on the card (forward and backward
    kernels) equal the plain forwards' autograd gradients; no output is
    detached from its inputs."""
    g = torch.Generator(device="cpu").manual_seed(3)
    x = torch.randn(512, 5, 64, generator=g).to(cuda_device, dtype).requires_grad_()
    go = torch.randn(512, 64, generator=g).to(cuda_device, dtype)
    before = (fm_cross.launches, fm_cross_bwd.launches)
    out = fm_cross(x)
    assert out.grad_fn is not None
    (dx,) = torch.autograd.grad(out, x, go)
    assert (fm_cross.launches, fm_cross_bwd.launches) == (before[0] + 1, before[1] + 1)
    x_ref = x.detach().requires_grad_()
    (dx_ref,) = torch.autograd.grad(fm_cross_plain(x_ref), x_ref, go)
    # autograd of the plain forward rounds dx once in the input dtype, as
    # the kernel does: within the kernel-against-plain tolerance.
    tol = fm_bwd_tolerance(x.detach(), go, dx_ref)
    assert bool(((dx.float() - dx_ref.float()).abs() <= tol).all())

    args = _din_inputs(256, 5, 10, 32, cuda_device)
    args[0] = args[0].to(dtype)
    args[1] = args[1].to(dtype)
    leaves = [a.detach().requires_grad_() for a in args]
    gd = torch.randn(256, 10, generator=g).to(cuda_device)
    before = din_attention_bwd.launches
    out = din_attention(*leaves)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, gd)
    assert din_attention_bwd.launches == before + 1
    ref_leaves = [a.detach().requires_grad_() for a in args]
    ref = torch.autograd.grad(din_attention_plain(*ref_leaves), ref_leaves, gd)
    for x_, r in zip(got, ref):
        assert x_.dtype == r.dtype
        scale = max(r.float().abs().max().item(), 1.0)
        tol_d = 1e-4 if x_.dtype == torch.float32 else 1e-2
        torch.testing.assert_close(x_.float(), r.float(), rtol=tol_d, atol=tol_d * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v,d,u", [(30001, 30, 4096), (1000, 128, 1000), (50, 7, 40), (10, 3, 0)])
def test_row_kernels_match_plain(cuda_device, dtype, v, d, u):
    """A row copy is exact: gathered and written rows are bit-equal."""
    g = torch.Generator(device="cpu").manual_seed(4)
    table = torch.randn(v, d, generator=g).to(cuda_device, dtype)
    ids = torch.randperm(v, generator=g)[:u].to(torch.int32).to(cuda_device)
    before = (rows_gather.launches, rows_write.launches)
    got = rows_gather(table, ids)
    assert torch.equal(got, rows_gather_plain(table, ids))
    rows = torch.randn(u, d, generator=g).to(cuda_device, dtype)
    drop = ids.clone()
    if u:
        drop[::3] = -1
        drop[1::7] = v + 5
    out = rows_write(table.clone(), drop, rows)
    ref = rows_write_plain(table.clone(), drop, rows)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    launched = 1 if u else 0
    assert (rows_gather.launches, rows_write.launches) == (before[0] + launched,
                                                            before[1] + launched)


@pytest.mark.cuda
def test_row_kernels_take_an_unaligned_odd_width(cuda_device):
    """A bf16 table of odd width (2-byte words) and an offset view."""
    base = torch.randn(1 + 64 * 5, device=cuda_device).bfloat16()
    table = base[1:].view(64, 5)
    ids = torch.tensor([3, 0, 63, 10], dtype=torch.int32, device=cuda_device)
    assert torch.equal(rows_gather(table, ids), rows_gather_plain(table, ids))


#: Row widths in elements: in f32 and bf16 they take every word width (16,
#: 8, 4 and 2 bytes) and every group width (1 to 32 lanes), rows wider
#: than a group (33, 384) included.
ROW_WIDTHS = (1, 5, 8, 10, 15, 16, 30, 32, 33, 128, 384)


def _rows_both_ways(table, gather_ids, write_ids, rows):
    """Gather and write through the kernels and the plain versions: each
    bit-equal, each wrapper launched exactly once (none for U = 0)."""
    before = (rows_gather.launches, rows_write.launches)
    got = rows_gather(table, gather_ids)
    assert torch.equal(got, rows_gather_plain(table, gather_ids))
    out = rows_write(table.clone(), write_ids, rows)
    torch.cuda.synchronize()
    assert torch.equal(out, rows_write_plain(table.clone(), write_ids, rows))
    launched = 1 if gather_ids.numel() and table.shape[1] else 0
    assert (rows_gather.launches, rows_write.launches) == (before[0] + launched,
                                                            before[1] + launched)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", ROW_WIDTHS)
@pytest.mark.parametrize("u", [0, 3, 1021, 70001])
def test_row_kernels_cover_every_word_and_group(cuda_device, dtype, d, u):
    """U = 0, fewer rows than one group takes, a count that is no multiple
    of the rows in flight, and 70,001 rows, which at wide rows take more
    blocks than one resident wave (the grid-stride loop), at every word
    and group width."""
    g = torch.Generator(device="cpu").manual_seed(d)
    v = 2 * u + 7
    table = torch.randn(v, d, generator=g).to(cuda_device, dtype)
    ids = torch.randperm(v, generator=g)[:u].to(torch.int32).to(cuda_device)
    rows = torch.randn(u, d, generator=g).to(cuda_device, dtype)
    plan = launch_plan(d * table.element_size(), table.data_ptr(), rows.data_ptr(), u)
    words = d * table.element_size() // plan.word_bytes
    assert plan.lanes >= min(words, 32)
    _rows_both_ways(table, ids, ids, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("v,d", [(30001, 30), (30001, 10), (1001, 30), (1001, 10)])
def test_row_kernels_on_the_trainers_padded_ids(cuda_device, v, d):
    """The row-Adam's ids for one batch: the gather's drop slots all clamp
    to row V-1, the write's lie at V and beyond and are skipped."""
    rng = np.random.default_rng(v + d)
    flat = torch.from_numpy(rng.integers(-3, v + 3, size=8192).astype(np.int32))
    uids, safe = _touched_rows(flat.to(cuda_device), v)
    assert int((safe == v - 1).sum()) > 1 and int((uids >= v).sum()) > 1
    g = torch.Generator(device="cpu").manual_seed(v)
    table = torch.randn(v, d, generator=g).to(cuda_device)
    rows = torch.randn(uids.shape[0], d, generator=g).to(cuda_device)
    _rows_both_ways(table, safe, uids, rows)


@pytest.mark.cuda
def test_row_kernels_take_an_offset_view_in_narrower_words(cuda_device):
    """A [V, 30] f32 view 4 bytes off: its 120-byte rows take 4-byte words
    where aligned ones take 8."""
    base = torch.randn(1 + 500 * 30, device=cuda_device)
    table = base[1:].view(500, 30)
    rows = torch.randn(200, 30, device=cuda_device)
    assert launch_plan(120, table.data_ptr(), rows.data_ptr(), 200).word_bytes == 4
    assert launch_plan(120, base.data_ptr(), rows.data_ptr(), 200).word_bytes == 8
    ids = torch.randperm(500)[:200].to(torch.int32).to(cuda_device)
    _rows_both_ways(table, ids, ids, rows)


@pytest.mark.parametrize("offset", [0, 2, 4, 8])
@pytest.mark.parametrize("u", [0, 1, 1021, 65536, 10 ** 7])
def test_launch_plan_fits_every_row_width_and_offset(offset, u):
    """Rows of 1 to 1,024 bytes between an aligned pointer and one
    `offset` bytes off: the widest word that divides the row and both
    pointers, a power of two of lanes no fewer than the row's words (at
    most 32) and the fewest such, a grid that covers U or is one resident
    wave. An odd byte width takes no word and raises."""
    base = 1 << 20
    for row_bytes in range(1, 1025):
        if row_bytes % 2:
            with pytest.raises(ValueError, match="2-byte words"):
                launch_plan(row_bytes, base, base + offset, u)
            continue
        plan = launch_plan(row_bytes, base, base + offset, u)
        word = plan.word_bytes
        assert word in WORDS and row_bytes % word == 0 and (base + offset) % word == 0
        assert all(row_bytes % w or offset % w for w in WORDS if w > word)
        words = min(row_bytes // word, 32)
        assert plan.lanes in (1, 2, 4, 8, 16, 32) and plan.lanes >= words
        assert plan.lanes == 1 or plan.lanes // 2 < words
        block_rows = THREADS // plan.lanes * ROWS_IN_FLIGHT
        assert plan.grid * block_rows >= u or plan.grid == MAX_GRID
        assert (plan.grid >= 1) == (u > 0) and plan.grid <= MAX_GRID


def test_row_wrappers_refuse_tensors_neither_on_the_cpu_nor_on_a_card():
    table = torch.zeros(4, 3, device="meta")
    ids = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        rows_gather(table, ids)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        rows_write(table, ids, torch.zeros(2, 3, device="meta"))


@pytest.mark.cuda
def test_row_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    table = torch.zeros(10, 4, device=cuda_device)
    ids = torch.arange(3, dtype=torch.int32, device=cuda_device)
    rows = torch.zeros(3, 4, device=cuda_device)
    strided = torch.arange(6, dtype=torch.int32, device=cuda_device)[::2]
    for bad_ids, match in ((ids.cpu(), "ids on"), (ids.long(), "int32"),
                           (ids.view(3, 1), "1-D"), (strided, "contiguous")):
        with pytest.raises(ValueError, match=match):
            rows_gather(table, bad_ids)
        with pytest.raises(ValueError, match=match):
            rows_write(table, bad_ids, rows)
    with pytest.raises(ValueError, match="contiguous"):
        rows_gather(torch.zeros(4, 10, device=cuda_device).t(), ids)
    with pytest.raises(ValueError, match=r"\[V, D\]"):
        rows_gather(torch.zeros(10, device=cuda_device), ids)
    with pytest.raises(ValueError, match="rows on"):
        rows_write(table, ids, rows.cpu())
    with pytest.raises(ValueError, match="rows of"):
        rows_write(table, ids, rows.double())
    with pytest.raises(ValueError, match="contiguous"):
        rows_write(table, ids, torch.zeros(4, 3, device=cuda_device).t())
    with pytest.raises(ValueError, match="rows"):
        rows_write(table, ids, rows[:2])
    with pytest.raises(ValueError, match="2-byte words"):
        rows_gather(torch.zeros(10, 3, dtype=torch.uint8, device=cuda_device), ids)


@pytest.mark.cuda
def test_row_adam_at_the_trainers_widths_on_the_card_equals_the_cpu(cuda_device):
    """`fused_row_adam_update` on a [30001, 3 x 10] buffer with padded ids
    of one batch: the card (the row kernels) and the CPU (the plain
    versions) agree bit for bit over three steps, with two gathers and one
    write launched a step."""
    rng = np.random.default_rng(9)
    table = rng.normal(size=(30001, 10)).astype(np.float32)
    f_cpu = init_fused_row_adam(torch.from_numpy(table.copy()))
    f_card = init_fused_row_adam(torch.from_numpy(table.copy()).to(cuda_device))
    for _ in range(3):
        ids = rng.integers(0, 30001, size=(8192, 1)).astype(np.int32)
        g = _adam_grads(rng, {"g": (30001, 10)})["g"]
        f_cpu = fused_row_adam_update(f_cpu, torch.from_numpy(g), torch.from_numpy(ids),
                                      learning_rate=1e-3)
        before = (rows_gather.launches, rows_write.launches)
        f_card = fused_row_adam_update(f_card, torch.from_numpy(g).to(cuda_device),
                                       torch.from_numpy(ids).to(cuda_device), learning_rate=1e-3)
        assert (rows_gather.launches, rows_write.launches) == (before[0] + 2, before[1] + 1)
        assert torch.equal(f_card.buf.cpu(), f_cpu.buf)


def _adam_grads(rng, shapes):
    """Gradients spanning 10 decades, where Adam's rounding shows."""
    return {k: (rng.normal(size=s) * 10.0 ** rng.integers(-8, 2, size=s)).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.cuda
def test_adam_on_the_card_equals_the_cpu_bit_for_bit(cuda_device):
    """`grouped_adam` and the fused row-Adam in float32 on the card (one
    rounding per moment update, IEEE sqrt) give the CPU's updates, which
    `tests/test_torch_optim.py` holds bit-equal to JAX's."""
    rng = np.random.default_rng(6)
    shapes = {"a": (300, 7), "big": (70000,), "c": (5,)}
    params = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for k, s in shapes.items()}
    tx = grouped_adam(1e-3, eps=1e-7)
    s_cpu, s_card = tx.init(params), tx.init({k: v.to(cuda_device) for k, v in params.items()})
    for _ in range(5):
        g = _adam_grads(rng, shapes)
        u_cpu, s_cpu = tx.update({k: torch.from_numpy(v) for k, v in g.items()}, s_cpu)
        u_card, s_card = tx.update({k: torch.from_numpy(v).to(cuda_device) for k, v in g.items()},
                                   s_card)
        for k in shapes:
            assert torch.equal(u_card[k].cpu(), u_cpu[k]), k
    table = rng.normal(size=(40, 6)).astype(np.float32)
    f_cpu = init_fused_row_adam(torch.from_numpy(table.copy()))
    f_card = init_fused_row_adam(torch.from_numpy(table.copy()).to(cuda_device))
    for _ in range(5):
        ids = rng.integers(-2, 43, size=(4, 9)).astype(np.int32)
        g = _adam_grads(rng, {"g": (40, 6)})["g"]
        f_cpu = fused_row_adam_update(f_cpu, torch.from_numpy(g), torch.from_numpy(ids),
                                      learning_rate=1e-3)
        f_card = fused_row_adam_update(f_card, torch.from_numpy(g).to(cuda_device),
                                       torch.from_numpy(ids).to(cuda_device), learning_rate=1e-3)
        assert torch.equal(f_card.buf.cpu(), f_cpu.buf)


@pytest.mark.cuda
def test_kernels_leave_the_callers_current_device(cuda_device):
    """Each of the six kernels launched on cuda:1 from a thread whose
    current device is cuda:0 leaves cuda:0 current (PyTorch reads its
    current device from the same CUDA thread-local the entry points set)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: on one card the tensors' device is always the "
                    "current one, so one H100 cannot show the fault")
    other = torch.device("cuda", 1)
    g = torch.Generator(device="cpu").manual_seed(7)
    x = torch.randn(64, 5, 16, generator=g).to(other)
    go = torch.randn(64, 16, generator=g).to(other)
    args = _din_inputs(32, 5, 10, 32, other)
    gd = torch.randn(32, 10, generator=g).to(other)
    table = torch.randn(100, 8, generator=g).to(other)
    ids = torch.arange(0, 100, 3, dtype=torch.int32, device=other)
    rows = torch.randn(ids.shape[0], 8, generator=g).to(other)
    calls = {
        "fm_cross": lambda: fm_cross(x),
        "fm_cross_bwd": lambda: fm_cross_bwd(x, go),
        "din_attention": lambda: din_attention(*args),
        "din_attention_bwd": lambda: din_attention_bwd(*args, gd),
        "rows_gather": lambda: rows_gather(table, ids),
        "rows_write": lambda: rows_write(table, ids, rows),
    }
    with torch.cuda.device(0):
        for name, call in calls.items():
            call()
            assert torch.cuda.current_device() == 0, name
    torch.cuda.synchronize(other)

"""The port's tool twins on the CPU: `tools.mfu_zoo`'s counts against the
JAX tool's, a tiny `tools.seq_signal` run against `seq_signal.json`'s keys
and the JAX generator's oracle, `tools.kernel_bench`'s bound arithmetic
against PERF.md's kernel table, its CLI without a card, and
`training.loop.hard_sync` on nested trees."""

import importlib.util
import json
import os
import types

import numpy as np
import pytest
import torch

from sparrowrecsys_torch.tools import kernel_bench as kb
from sparrowrecsys_torch.tools import mfu_zoo, seq_signal
from sparrowrecsys_torch.training.loop import hard_sync

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = mfu_zoo.DEFAULT_MODELS.split(",")


@pytest.fixture(scope="module")
def jax_mfu_zoo():
    spec = importlib.util.spec_from_file_location("jax_mfu_zoo",
                                                  os.path.join(REPO, "tools", "mfu_zoo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: (dim, hidden, t, user vocab, movie vocab, batch): the tools' defaults
#: (DIN and DIEN at their batch) and a small one.
CONFIGS = [(128, 1024, 64, 1 << 20, 1 << 17, 65536), (16, 48, 7, 1000, 501, 512)]


@pytest.mark.parametrize("spec", MODELS)
@pytest.mark.parametrize("cfg", CONFIGS, ids=["defaults", "small"])
def test_mfu_counts_equal_the_jax_tools(jax_mfu_zoo, spec, cfg):
    dim, hidden, t, uv, mv, batch = cfg
    name, aux = ("dien", "paper") if spec == "dien_paper" else (spec, "none")
    t = t if name in ("din", "dien") else 5
    _, _, want, _ = jax_mfu_zoo.model_config(name, dim, hidden, t, uv, mv, aux)
    assert mfu_zoo.flops_per_example(name, dim, hidden, t, aux) == want
    assert mfu_zoo.hbm_bytes_per_step(name, dim, hidden, t, batch, uv, mv) == \
        jax_mfu_zoo.hbm_bytes_per_step(name, dim, hidden, t, batch, uv, mv)


def test_mfu_zoo_runs_every_model_on_the_cpu():
    args = mfu_zoo.parser().parse_args(
        ["--cpu", "--dim", "16", "--hidden", "32", "--t", "8", "--batch", "256",
         "--seq-batch", "128", "--user-vocab", "1000", "--movie-vocab", "500",
         "--warmup", "1", "--steps", "2"])
    rows = mfu_zoo.run(args)
    assert [r["model"] for r in rows] == MODELS
    for r in rows:
        assert r["ms_per_step"] > 0 and np.isfinite(r["loss"])
        assert r["tflops"] == pytest.approx(
            r["flops_per_example_M"] * 1e6 * r["examples_per_s"] / 1e12)
        assert r["bf16_peak_share"] == pytest.approx(r["tflops"] * 1e12 / mfu_zoo.BF16_PEAK)
        assert r["launches"] == {}                          # the plain versions on the CPU
    dtypes = {r["model"]: r["kernel_dtypes"] for r in rows}
    assert dtypes["din"] == {"din_attention": "float32"}
    assert set(dtypes["deepfm_v2"]) == {"fm_cross"}
    assert dtypes["embedding_mlp"] == {}


SEQ_ARGV = ["--cpu", "--n", "1500", "--test-n", "500", "--seeds", "1", "--epochs", "1",
            "--batch-size", "500", "--models", "deepfm,din,dien", "--datasets",
            "sequence,drift,marginal"]


def _seq_args(**kw):
    args = seq_signal.parser().parse_args(SEQ_ARGV)
    vars(args).update(kw)
    return args


def test_seq_signal_writes_the_reference_files_keys(tmp_path):
    out = tmp_path / "seq.json"
    doc = seq_signal.main(SEQ_ARGV + ["--json-out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(doc))
    with open(os.path.join(REPO, "seq_signal.json")) as f:
        ref = json.load(f)
    assert set(ref) == set(doc)
    assert set(ref["config"]) <= set(doc["config"])
    assert set(ref["results"]["sequence"]) == set(doc["results"]["sequence"])
    assert set(ref["results"]["sequence"]["models"]["din"]) == \
        set(doc["results"]["sequence"]["models"]["din"])
    for dname in ("sequence", "drift", "marginal"):
        res = doc["results"][dname]
        assert list(res["models"]) == ["deepfm", "din", "dien"]
        for r in res["models"].values():
            assert 0.0 <= r["mean"] <= 1.0 and len(r["seeds"]) == 1
    assert doc["results"]["marginal"]["oracle_roc_auc"] is None


@pytest.mark.parametrize("dname", ["sequence", "drift"])
def test_seq_signal_oracle_is_the_jax_generators_exact_auc(dname):
    """The oracle row is the exact AUC of the planted logit on the test
    slice of JAX's generator with the tool's arguments."""
    from sparrowrecsys_tpu.data.synthetic import drift_ctr_with_oracle, sequence_ctr_with_oracle
    from sparrowrecsys_tpu.ops.metrics import exact_auc

    args = _seq_args(models="deepfm", datasets=dname)
    doc = seq_signal.run(args, log=lambda m: None)
    total = args.n + args.test_n
    if dname == "sequence":
        full, oracle = sequence_ctr_with_oracle(
            total, seed=7, t=args.t, compat_dim=args.compat_dim, gain=args.gain,
            recency=args.recency, markov_tau=args.markov_tau)
    else:
        full, oracle = drift_ctr_with_oracle(
            total, seed=7, t=args.t, compat_dim=args.compat_dim, gain=args.gain,
            drift_rho=args.drift_rho, tau=args.drift_tau)
    want = exact_auc(1 / (1 + np.exp(-oracle[args.n:])), full.labels[args.n:])["roc_auc"]
    assert doc["results"][dname]["oracle_roc_auc"] == want
    assert want > 0.8


def test_seq_signal_dataset_cache_round_trips(tmp_path):
    cache = str(tmp_path / "seq.npz")
    args = _seq_args(models="deepfm", datasets="sequence", dataset_cache=cache)
    first = seq_signal.run(args, log=lambda m: None)
    assert os.path.exists(cache)
    again = seq_signal.run(args, log=lambda m: None)
    assert again["results"] == first["results"]


# ---- kernel_bench ------------------------------------------------------------


def _ms(cost):
    return kb.bound(*cost)


@pytest.mark.parametrize("fn, shape, size, want_ms", [
    # PERF.md section 6, the kernel table's bounds (all set by bytes).
    (kb.fm_cross_cost, (8192, 5, 64), 4, 0.0038),
    (kb.fm_cross_cost, (262144, 5, 128), 4, 0.2404),
    (kb.fm_cross_cost, (262144, 5, 128), 2, 0.1202),
    (kb.fm_cross_bwd_cost, (65536, 5, 64), 4, 0.0551),
    (kb.fm_cross_bwd_cost, (262144, 5, 128), 4, 0.4407),
    (kb.fm_cross_bwd_cost, (262144, 5, 128), 2, 0.2204),
])
def test_fm_bounds_match_the_kernel_table(fn, shape, size, want_ms):
    ms, by = _ms(fn(*shape, size))
    assert by == "bytes"
    assert ms == pytest.approx(want_ms, abs=5e-5)


def test_fm_cross_cost_formula():
    b, f, d = 3, 5, 7
    assert kb.fm_cross_cost(b, f, d, 4) == ((b * f * d + b * d) * 4, 3 * b * f * d + 2 * b * d)
    assert kb.fm_cross_bwd_cost(b, f, d, 2) == ((2 * b * f * d + b * d) * 2, 3 * b * f * d + b * d)


def test_din_costs_follow_the_live_steps():
    b, t, d, h = 8192, 5, 10, 32
    nbytes, flops = kb.din_attention_cost(b, t, d, h, live_steps=28_672, live_rows=8_172)
    assert nbytes == (b * t * d + 2 * b * d + 4 * d * h + 3 * h + 1) * 4
    assert flops == 2 * (28_672 * (2 * d * h + h) + 8_172 * d * h)
    assert _ms((nbytes, flops)) == (pytest.approx(0.00069, abs=5e-6), "bytes")
    tc = kb.bound(nbytes, flops, kb.TC_F32_FLOPS)
    assert tc == (pytest.approx(0.00069, abs=5e-6), "bytes")
    # The backward: 2 (live (6DH + 4H) + live_rows 3DH). Its operations at
    # the tensor cores' float32 rate (three TF32 products a product), the
    # rate the DIN kernels' bound takes, fall below its bytes at the
    # training shape (0.0102 ms in the kernel table, its own data); at the
    # float32 rate outside the tensor cores they would set it.
    live, rows = 229_376, 65_370
    nbytes, flops = kb.din_attention_bwd_cost(65536, 5, 10, 32, live, rows)
    assert flops == 2 * (live * (6 * 10 * 32 + 4 * 32) + rows * 3 * 10 * 32)
    assert _ms((nbytes, flops))[1] == "operations"
    assert kb.bound(nbytes, flops, kb.TC_F32_FLOPS) == (pytest.approx(0.01018, abs=5e-5), "bytes")
    assert kb.din_attention_cost(b, t, d, h, 0, 0)[1] == 0


@pytest.mark.parametrize("fn, u, n, row_bytes, want_ms", [
    # DeepFMv2's user buffer [30001, 30] f32: 26,629 distinct rows of 65,536.
    (kb.rows_gather_bytes, 65536, 26_629, 120, 0.00338),
    (kb.rows_write_bytes, 65536, 26_629, 120, 0.00199),
    # its movie buffer [1001, 30]: about 1,000 in range.
    (kb.rows_write_bytes, 65536, 1_000, 120, 0.00015),
])
def test_row_bounds_match_the_kernel_table(fn, u, n, row_bytes, want_ms):
    assert kb.bound(fn(u, n, row_bytes), 0) == (pytest.approx(want_ms, abs=5e-6), "bytes")


def test_bound_takes_the_longer_of_bytes_and_operations():
    assert kb.bound(kb.HBM_BYTES_PER_S * 1e-3, 0) == (1.0, "bytes")
    assert kb.bound(0, kb.F32_FLOPS * 2e-3) == (2.0, "operations")


def test_kernel_bench_cli_without_a_card_exits_non_zero(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert kb.main([]) != 0
    assert capsys.readouterr().out == ""


# ---- hard_sync ---------------------------------------------------------------


def test_hard_sync_accepts_nested_trees():
    leaf = torch.arange(6.0).reshape(2, 3)
    for tree in (leaf, {"a": leaf}, [leaf], ({"x": [torch.zeros(0), (leaf,)]}, 3),
                 {"placeholder": torch.zeros(0), "p": {"q": [leaf]}}, {}, [], torch.tensor(1.0),
                 types.SimpleNamespace(), None):
        assert hard_sync(tree) is None


def test_hard_sync_reads_one_element_of_the_first_non_empty_leaf(monkeypatch):
    reads = []
    real = torch.Tensor.cpu

    def spy(self, *a, **k):
        reads.append(self.numel())
        return real(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    hard_sync({"empty": torch.zeros(0), "w": [torch.ones(4, 5), torch.ones(3)]})
    assert reads == [1]

"""The DLRM-DCNv2 cell (`dlrm_dcnv2_mlperf.train_b8192`) on the CPU: its
entries, `drivers/dlrm_train_steps.py` through the harness at a CPU size,
its readers, its costs and its reference's frozen copy.

    python -m pytest benchmark/tests/test_bench_dlrm.py -q
"""

from __future__ import annotations

import filecmp
import io
import json
import os

import pytest
import torch

from benchmark import costs_dlrm, harness
from benchmark.drivers import dlrm_train_steps as drv
from benchmark.tests.tiny import REPO, make_root

CELL = "dlrm_dcnv2_mlperf.train_b8192"
CONFIG = "benchmark/configs/dlrm_dcnv2_mlperf.json"
NEW = ("pooled_lookup_ms.train", "cross_ms.train", "row_adam_ms.train",
       "row_adam_roofline.train")
GENERIC = ("train_mfu", "device_ops_per_step.train", "device_idle.train", "forward_ms.train",
           "backward_ms.train", "optimizer_ms.train", "embedding_bwd_ms.train",
           "backward_idle_ms.train", "host_syncs_per_step.train")
CHECKS = {"loss_gap", "out_grad1_gap", "grad1_gap", "grad1_median_gap", "change_gap", "change_median_gap",
          "table_grad1_gap", "table_change_gap"}
#: The configuration cut for a CPU run: D = 8, cross rank 4, narrow MLPs,
#: tables of at most 3,000 rows (sixteen of them outside `bwd_fits` at
#: D = 8), the published multi-hot sizes; batch 64.
CPU_CONFIG = {"embedding_dim": 8, "dense_arch_layer_sizes": [16, 8],
              "over_arch_layer_sizes": [32, 16, 1], "dcn_low_rank_dim": 4}
SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module")
def bench():
    return harness.load_json(os.path.join(REPO, "BENCHMARK.json"))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = make_root(str(tmp_path_factory.mktemp("dlrm") / "root"))
    path = os.path.join(root, CONFIG)
    cfg = harness.load_json(path)
    cfg.update(CPU_CONFIG)
    cfg["num_embeddings_per_feature"] = [min(r, 3000) for r in cfg["num_embeddings_per_feature"]]
    with open(path, "w") as f:
        json.dump(cfg, f)
    path = os.path.join(root, "benchmark", "traffic", "train_dlrm.json")
    traffic = harness.load_json(path)
    traffic["batch"] = 64
    with open(path, "w") as f:
        json.dump(traffic, f)
    return root


def test_entries_of_the_cell(bench):
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 1 and cell["traffic"] == "train_dlrm" and len(cell["why"]) <= 200
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    assert config["file"] == CONFIG and config["reduced"] == ["num_embeddings_per_feature"]
    assert len(config["why"]) <= 200 and len(config["source"]) <= 200
    cfg = harness.load_json(os.path.join(REPO, CONFIG))
    assert cfg["reduced"] == config["reduced"]
    assert (cfg["embedding_dim"], cfg["dense_arch_layer_sizes"], cfg["over_arch_layer_sizes"],
            cfg["dcn_num_layers"], cfg["dcn_low_rank_dim"]) == \
        (128, [512, 256, 128], [1024, 1024, 512, 256, 1], 3, 512)
    assert sum(cfg["multi_hot_sizes"]) == 214 and len(cfg["multi_hot_sizes"]) == 26
    held = [5000000 if r == 40000000 else r for r in cfg["published_num_embeddings_per_feature"]]
    assert cfg["num_embeddings_per_feature"] == held and sum(held) == 29184588
    reads = {m["name"] for m in bench["per_layer"] if CELL in m.get("workloads", [])}
    assert reads == set(NEW) | set(GENERIC)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert CELL in e2e["train_examples_per_s"]["workloads"]
    assert set(harness.limits_of(REPO, CELL)) == CHECKS


def test_the_two_reference_files_are_one():
    assert filecmp.cmp(os.path.join(REPO, "reference", "dlrm_dcnv2.py"),
                       os.path.join(REPO, "benchmark", "reference", "dlrm_dcnv2.py"),
                       shallow=False)


def test_flops_are_an_independent_count_of_the_widths():
    """Every weight element of the model's dense arch, cross layers and
    over arch is one multiply-add an example: their count, read off the
    program's model on the meta device, is half the FLOPs."""
    cfg = harness.load_json(os.path.join(REPO, CONFIG))
    macs = sum(p.numel() for k, p in drv.model_on_meta(cfg).named_parameters()
               if k.endswith(".weight") or k.endswith(".v") or k.endswith(".w"))
    assert costs_dlrm.config_flops_per_example(cfg) == 2.0 * macs == 2.0 * 16030464


def test_row_adam_bytes_count_distinct_rows():
    # two tables at D = 128: 10 and 3 distinct rows of 7 x 128 floats, 40 ids
    assert costs_dlrm.row_adam_bytes([10, 3], [30, 10], 128) == 13 * 7 * 128 * 4 + 40 * 4


def _run(root, trace):
    out, err = io.StringIO(), io.StringIO()
    harness.run_cell(root, CELL, SEED, 1, trace, device="cpu", stdout=out, stderr=err)
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_and_is_correct_on_the_cpu(root, trace):
    line, err = _run(root, trace)
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == CHECKS
    if trace:
        assert "train_mfu" in line["metrics"] and "breakdown" in line
    else:
        assert set(line["metrics"]) == {"train_examples_per_s", "setup_s"}
    assert "[bench] sparse_tables: 16" in err


def _with_kernels(tr, names, us=1000.0):
    """The trace with one launch and one 1 ms kernel inside each range
    named in `names`, as the card's would hold."""
    events = tr.host + tr.device
    corr = 10 ** 6
    for e in list(tr.host):
        if e.get("name") in names:
            corr += 1
            ts = float(e["ts"]) + 0.1
            events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                           "ts": ts, "dur": 0.01, "tid": e.get("tid"), "pid": e.get("pid"),
                           "args": {"correlation": corr}})
            events.append({"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": us,
                           "tid": 7, "pid": 0, "args": {"correlation": corr}})
    return type(tr)(events)


def test_a_traced_run_holds_the_spans_the_new_readers_read(root, bench):
    """A traced run of `drivers/dlrm_train_steps.py` on the CPU: its trace holds the program's
    `dlrm.*` and `trainer.row_adam` ranges, one set a traced step. With a
    kernel launched inside each (the CPU launches none), the four new
    readers read them, the roofline below 100%."""
    _, cell, config, traffic = harness.resolve(root, CELL)
    ctx = harness.Context(root=root, cell=cell, config=config, traffic=traffic, seed=SEED,
                          seconds=1, trace=True, device="cpu")
    drv.run(ctx)
    tr, n = ctx.device_trace, ctx.values["traced_steps"]
    names = ("trainer.step", "dlrm.lookups", "dlrm.cross", "dlrm.cross.backward",
             "trainer.row_adam")
    assert all(len(tr.ranges(name)) == n for name in names)
    assert ctx.values["row_adam_bytes"] > 0
    ctx.device_trace = _with_kernels(tr, names[1:])
    got = harness.per_layer(ctx, bench, ["train_examples_per_s"])
    assert set(NEW) <= set(got)
    assert got["pooled_lookup_ms.train"]["value"] == pytest.approx(1.0)
    assert got["cross_ms.train"]["value"] == pytest.approx(2.0)
    assert got["row_adam_ms.train"]["value"] == pytest.approx(1.0)
    assert 0 < got["row_adam_roofline.train"]["value"] < 100


def test_readers_find_nothing_without_the_spans():
    """A run whose program has no `dlrm.*` or `trainer.row_adam` span, or
    no device trace at all, reads None from the new readers."""
    ctx = harness.Context(root=REPO, cell={"name": CELL}, config={}, traffic={}, seed=1,
                          seconds=1, trace=True)
    ctx.values["row_adam_bytes"] = 1e6
    for name in NEW:
        assert harness.load_reader(REPO, name)(ctx) is None


def test_the_lazy_tables_come_from_the_configuration(monkeypatch, root):
    """The configuration's lazy tables are those of more than
    `lazy_adam_table_bytes`; a program whose model names another set fails
    before it trains, rather than taking the reference with it."""
    from sparrowrecsys_torch.models.dlrm import DLRMDCNv2

    _, cell, config, traffic = harness.resolve(root, CELL)
    assert len(drv.sparse_names(config)) == 16
    full = harness.load_json(os.path.join(REPO, CONFIG))
    assert [int(k.split("_")[2].split(".")[0]) for k in drv.sparse_names(full)] == \
        [0, 1, 2, 3, 4, 6, 7, 9, 10, 11, 13, 14, 15, 17, 19, 20, 21, 22, 23]
    real = DLRMDCNv2.sparse_tables
    monkeypatch.setattr(DLRMDCNv2, "sparse_tables",
                        lambda self: dict(list(real(self).items())[1:]))
    ctx = harness.Context(root=root, cell=cell, config=config, traffic=traffic, seed=1,
                          seconds=1, trace=False, device="cpu")
    with pytest.raises(ValueError, match="lazy tables"):
        drv.run(ctx)


def test_a_program_without_the_model_fails_before_any_work(monkeypatch, root):
    from sparrowrecsys_torch import models

    monkeypatch.delitem(models.MODEL_REGISTRY, "dlrm_dcnv2")
    built = []
    monkeypatch.setattr(drv, "Job", built.append)
    _, cell, config, traffic = harness.resolve(root, CELL)
    ctx = harness.Context(root=root, cell=cell, config=config, traffic=traffic, seed=1,
                          seconds=1, trace=False, device="cpu")
    with pytest.raises(KeyError, match="dlrm_dcnv2"):
        drv.run(ctx)
    assert not built


def test_the_reference_holds_only_the_touched_rows_exactly(root):
    """The reference's readings with each sparse table held in part (the
    rows the checked steps touch, the ids remapped) equal those with the
    whole tables held."""
    from benchmark import weights_dlrm
    from benchmark.drivers import train_steps
    from benchmark.reference import dlrm_dcnv2 as ref

    _, cell, config, traffic = harness.resolve(root, CELL)
    ctx = harness.Context(root=root, cell=cell, config=config, traffic=traffic, seed=SEED,
                          seconds=1, trace=False, device="cpu")
    sparse = drv.sparse_names(config)
    part = drv.reference_readings(ctx, sparse)
    batch = traffic["batch"]
    feats, labels = weights_dlrm.train_columns(config, traffic, SEED, "cpu",
                                               train_steps.POOL_BATCHES * batch)
    batches = [({k: v[i * batch:(i + 1) * batch] for k, v in feats.items()},
                labels[i * batch:(i + 1) * batch]) for i in range(train_steps.CHECKED_STEPS)]
    whole = ref.train_readings(weights_dlrm.make_all(config, SEED, "cpu"), batches, sparse,
                               config["optimizer"])
    assert part["loss"] == pytest.approx(whole["loss"], rel=1e-6)
    for k in whole["grad1"]:
        assert part["grad1"][k] == pytest.approx(whole["grad1"][k], rel=1e-5, abs=1e-12), k
        assert part["change"][k] == pytest.approx(whole["change"][k], rel=1e-5, abs=1e-12), k
    torch.testing.assert_close(torch.tensor(len(sparse)), torch.tensor(16))

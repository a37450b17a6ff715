"""The port's multi-device plane against the JAX package's, on the CPU.

The JAX side runs in this process on the 8 virtual CPU devices that
conftest.py forces (a 2x2 mesh on 4 of them). The port's ranks are
spawned processes over gloo, one per rank (`parallel.scaling.spawn_ranks`
with `tools.dryrun_multichip.mesh_worker`); one spawn of a 2x2 mesh runs
every sharded case while this process runs the JAX fits:
- 2-epoch fits of DeepFM, DeepFMv2 with a sparse user table, DIN and DIEN
  (512 rows, batch 128, buckets 30,002/1,002, every table of at least 16
  rows row-sharded, as `tests/test_sharded_training.py` has them) from
  JAX's initial weights and JAX's row order, held to JAX's single-device
  fit and to JAX's 2x2 `Trainer(plan=)` with that file's bounds: loss
  1e-3 (2e-3 for DIN and DIEN), ROC-AUC 5e-3, every parameter 1e-3;
- `sharded_lookup` at V = 1,003, D = 8 with ids -1 and >= V, bit-equal
  to JAX's on the same 2x2 mesh, and its backward against the gradient
  of a single-device gather to 1e-6 of its scale;
- `sharded_cosine_topk` (raw, prepared, and tied rows straddling the
  shard boundary) against JAX's: indices equal, scores to rtol 1e-5;
- the optimizer's small-leaf split, decided by the whole size: an
  8,192 x 10 table at n_model = 2 keeps bfloat16 moments (and is
  narrowed under bf16_table_params) as in JAX.
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparrowrecsys_torch.config import MeshConfig, TrainConfig
from sparrowrecsys_torch.data.dataset import EncodedDataset
from sparrowrecsys_torch.models import build_model
from sparrowrecsys_torch.models.dien import dien_loss_fn
from sparrowrecsys_torch.ops.topk import cosine_topk, prepare_catalog, sharded_cosine_topk
from sparrowrecsys_torch.parallel import (
    MeshPlan,
    build_mesh,
    measure_scaling,
    param_shardings,
    spawn_ranks,
)
from sparrowrecsys_torch.tools.dryrun_multichip import mesh_worker
from sparrowrecsys_torch.training.checkpoint import params_from_flax, params_to_flax
from sparrowrecsys_torch.training.loop import Trainer
from sparrowrecsys_tpu.config import MeshConfig as JaxMeshConfig
from sparrowrecsys_tpu.config import TrainConfig as JaxTrainConfig
from sparrowrecsys_tpu.data.negatives import add_dien_negatives
from sparrowrecsys_tpu.data.synthetic import synthetic_ctr_dataset
from sparrowrecsys_tpu.models import build_model as jax_build
from sparrowrecsys_tpu.models.dien import dien_loss_fn as jax_dien_loss_fn
from sparrowrecsys_tpu.ops.embedding import sharded_lookup as jax_sharded_lookup
from sparrowrecsys_tpu.ops.topk import prepare_catalog as jax_prepare
from sparrowrecsys_tpu.ops.topk import sharded_cosine_topk as jax_sharded_topk
from sparrowrecsys_tpu.parallel.mesh import build_mesh as jax_build_mesh
from sparrowrecsys_tpu.parallel.mesh import param_shardings as jax_param_shardings
from sparrowrecsys_tpu.parallel.mesh import shard_params as jax_shard_params
from sparrowrecsys_tpu.training.loop import Trainer as JaxTrainer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = (30002, 1002)
CFG = dict(batch_size=128, epochs=2, shuffle_each_epoch=True, seed=11)
FITS = {"deepfm": None, "deepfm_v2": {"emb_userId": ("userId",)}, "din": None, "dien": None,
        "deepfm_v2_padded": {"emb_userId": ("userId",)}}
LOSS_TOL = {"deepfm": 1e-3, "deepfm_v2": 1e-3, "din": 2e-3, "dien": 2e-3,
            "deepfm_v2_padded": 1e-3}
#: Rows per fit: 450 leaves a last batch of 66 rows, 64 on one data rank
#: and 2 on the other, so only a global normalisation of the loss lands
#: on the single-device fit.
ROWS = {"deepfm_v2_padded": 450}
V, D, N_IDS = 1003, 8, 64


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v, np.float64)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _model_name(name):
    return name.removesuffix("_padded")


def _jax_data(name):
    ds = synthetic_ctr_dataset(ROWS.get(name, 512), user_vocab=BUCKETS[0], movie_vocab=BUCKETS[1], seed=3)
    if name == "dien":
        ds = add_dien_negatives(ds, seed=2020, vocab=BUCKETS[1])
    return ds


def _jax_trainer(name, plan=None):
    return JaxTrainer(jax_build(_model_name(name), user_buckets=BUCKETS[0], movie_buckets=BUCKETS[1]),
                      JaxTrainConfig(**CFG), plan=plan, sparse_tables=FITS[name],
                      loss_fn=jax_dien_loss_fn() if name == "dien" else None)


def _port_model(name):
    return build_model(_model_name(name), user_buckets=BUCKETS[0], movie_buckets=BUCKETS[1])


def _lookup_inputs():
    rng = np.random.default_rng(5)
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(0, V, N_IDS).astype(np.int32)
    ids[[0, 9, 40]] = -1
    ids[[3, 33]] = (V, V + 7)
    ids[[5, 6]] = (V - 1, 501)           # the last row; the first shard's last row
    cot = rng.normal(size=(N_IDS, D)).astype(np.float32)
    return table, ids, cot


def _topk_inputs():
    rng = np.random.default_rng(0)
    items = rng.normal(size=(V, 16)).astype(np.float32)
    queries = rng.normal(size=(6, 16)).astype(np.float32)
    # Row 7 and ten rows across the 502-row block edge score exactly 1 for
    # query 0 (one-hot rows: the products and norms are exact).
    ties = items.copy()
    ties[[7, *range(498, 508)]] = 0.0
    ties[[7, *range(498, 508)], 0] = 2.0
    tq = queries.copy()
    tq[0] = 0.0
    tq[0, 0] = 3.0
    return {"raw": {"items": items, "queries": queries, "k": 7},
            "prepared": {"items": items, "queries": queries, "k": 7, "prepared": True},
            "ties": {"items": ties, "queries": tq, "k": 6}}


#: DIEN drawing its negatives in the step: the ranks draw them for the
#: global batch (`loss_fn.draw`) and take their rows.
DIEN_RNG = {"model": "dien", "in_graph_negatives": True, "rows": 450}
SPLIT = {"model": "deepfm", "buckets": (8192, 1002), "min_rows": 4096,
         "config": {"big_moment_dtype": "bfloat16"}}
SPLIT_BF16 = {**SPLIT, "config": {"big_moment_dtype": "bfloat16", "bf16_table_params": True}}


@pytest.fixture(scope="module")
def mesh_run():
    """One 2x2 spawn of the port running every case, beside JAX's fits in
    this process. Returns (the ranks' results, JAX's, the fit inputs)."""
    job, inputs = [], {}
    for name, sparse in FITS.items():
        jds = _jax_data(name)
        init = jax.tree.map(np.array, _jax_trainer(name).init_params(jds.features))
        orders = [np.asarray(jax.random.permutation(jax.random.PRNGKey(CFG["seed"] + e), len(jds)))
                  for e in range(CFG["epochs"])]
        port_init = {k: v.numpy() for k, v in params_from_flax(init, _port_model(name)).items()}
        inputs[name] = (jds, init)
        job.append((name, "fit", {"model": _model_name(name), "features": jds.features, "labels": jds.labels,
                                  "init": port_init, "orders": orders, "sparse_tables": sparse}))
    table, ids, cot = _lookup_inputs()
    job.append(("lookup", "lookup", {"table": table, "ids": ids, "cotangent": cot}))
    for kind, case in _topk_inputs().items():
        job.append((f"topk_{kind}", "topk", case))
    job += [("split", "split", SPLIT), ("split_bf16", "split", SPLIT_BF16),
            ("dien_rng", "fit", DIEN_RNG)]
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn_ranks, mesh_worker, (2, 2), (job, "cpu"), timeout=600)
        jplan = jax_build_mesh(JaxMeshConfig(data_parallel=2, model_parallel=2),
                               devices=jax.devices()[:4])
        jax_res = {}
        for name, (jds, init) in inputs.items():
            single = _jax_trainer(name).fit(jds, params=jax.tree.map(jnp.asarray, init),
                                            verbose=False)
            sharded = _jax_trainer(name, jplan).fit(
                jds, params=jax_shard_params(init, jplan, min_rows=16), verbose=False)
            jax_res[name] = {label: ([{k: float(v) for k, v in h.items()} for h in r.history],
                                     _flat(r.params))
                             for label, r in (("single", single), ("sharded", sharded))}
        return ranks.result(), jax_res, jplan


@pytest.mark.parametrize("n_model", [1, 2, 4])
def test_name_rule_matches_jax(n_model):
    shapes = {"emb_userId.table": (30002, 10), "emb_movieId.table": (1002, 10),
              "emb_userGenre1.table": (19, 10), "bias_userId.w": (30002, 1),
              "odd.table": (30001, 10), "deep1.weight": (97, 128), "deep1.bias": (128,),
              "flat.w": (8192,), "wide_cross.w": (10000, 1)}
    params = {k: torch.zeros(s) for k, s in shapes.items()}
    plan = MeshPlan(n_data=8 // n_model, n_model=n_model)
    jplan = jax_build_mesh(JaxMeshConfig(model_parallel=n_model))
    for min_rows in (16, 4096):
        got = param_shardings(params, plan, min_rows)
        tree = {}
        for k, shape in shapes.items():
            mod, leaf = k.split(".")
            tree.setdefault(mod, {})[leaf] = np.zeros(shape, np.float32)
        want = jax_param_shardings(tree, jplan, min_rows)
        for k in shapes:
            mod, leaf = k.split(".")
            assert got[k] == tuple(want[mod][leaf].spec), (k, min_rows)


def test_build_mesh_without_a_group_is_1x1_and_checks_factorisation():
    plan = build_mesh()
    assert (plan.n_data, plan.n_model, plan.rank, plan.comm) == (1, 1, 0, None)
    t = torch.arange(4.0)
    assert plan.all_reduce(t, "data") is t and plan.all_gather(t, "model") is t
    for cfg in (dict(data_parallel=3, model_parallel=2), dict(model_parallel=2)):
        with pytest.raises(ValueError):
            build_mesh(MeshConfig(**cfg))
    with pytest.raises(ValueError):
        jax_build_mesh(JaxMeshConfig(data_parallel=3, model_parallel=2))


def test_rank_layout_is_jax_device_layout(mesh_run):
    """rank = d * n_model + m, as np.array(devices).reshape(dp, mp) lays them out."""
    ranks, _, jplan = mesh_run
    grid = np.arange(4).reshape(2, 2)
    for r, out in enumerate(ranks):
        d, m = out["coords"][1:]
        assert out["coords"][0] == r and grid[d, m] == r
        assert jplan.mesh.devices[d, m] == jax.devices()[r]


def test_sharded_lookup_forward_bit_equal_jax(mesh_run):
    ranks, _, jplan = mesh_run
    table, ids, _ = _lookup_inputs()
    block = -(-V // 2)
    want = np.asarray(jax_sharded_lookup(jnp.asarray(table), jnp.asarray(ids), jplan.mesh))
    per = N_IDS // 2
    for out in ranks:
        d = out["coords"][1]
        np.testing.assert_array_equal(out["lookup"]["out"], want[d * per:(d + 1) * per])
    # ids -1 and >= V give zeros; the rows either side of the shard edge do not.
    assert not want[[0, 3, 33]].any() and want[6].any() and block == 502


def test_sharded_lookup_backward_matches_single_device_gather(mesh_run):
    ranks, _, _ = mesh_run
    table, ids, cot = _lookup_inputs()
    t = torch.from_numpy(table).requires_grad_()
    valid = torch.from_numpy((ids >= 0) & (ids < V))
    rows = torch.nn.functional.embedding(torch.from_numpy(ids).long().clamp(0, V - 1), t)
    (torch.where(valid[:, None], rows, 0.0) * torch.from_numpy(cot)).sum().backward()
    want = t.grad.numpy()
    scale = np.abs(want).max()
    for out in ranks:
        np.testing.assert_allclose(out["lookup"]["grad"], want, rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("kind", ["raw", "prepared", "ties"])
def test_sharded_topk_matches_jax(mesh_run, kind):
    ranks, _, jplan = mesh_run
    case = _topk_inputs()[kind]
    items = jnp.asarray(case["items"])
    cat = jax_prepare(items) if case.get("prepared") else items
    s, i = jax_sharded_topk(jnp.asarray(case["queries"]), cat, case["k"], jplan.mesh)
    for out in ranks:
        got = out[f"topk_{kind}"]
        np.testing.assert_array_equal(got["indices"], np.asarray(i))
        np.testing.assert_allclose(got["scores"], np.asarray(s), rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(got["indices"], got["single_indices"])
    if kind == "ties":
        np.testing.assert_array_equal(np.asarray(i)[0], [7, 498, 499, 500, 501, 502])


def test_sharded_topk_prepared_rule():
    plan = build_mesh()
    items = torch.randn(20, 4, generator=torch.Generator().manual_seed(0))
    q = items[:3]
    with pytest.raises(TypeError):
        sharded_cosine_topk(q, items, 3, plan, prepared=True)
    s, i = sharded_cosine_topk(q, prepare_catalog(items), 3, plan)
    s1, i1 = cosine_topk(q, items, 3)
    assert torch.equal(i, i1) and torch.allclose(s, s1)


@pytest.mark.parametrize("name", list(FITS))
def test_fit_2x2_matches_jax(mesh_run, name):
    ranks, jax_res, _ = mesh_run
    got = ranks[0][name]
    assert got["shardings"]["emb_userId.table"] == ("model", None)
    assert got["shardings"]["emb_movieId.table" if name.startswith("deepfm")
                            else "emb_movie_shared.table"] == ("model", None)
    hist = got["history"]
    for r in ranks[1:]:
        assert r[name]["history"] == hist          # the metric state is summed over data
    params = _flat(params_to_flax({k: torch.from_numpy(v) for k, v in got["params"].items()},
                                  _port_model(name)))
    for label in ("single", "sharded"):
        ref_hist, ref_params = jax_res[name][label]
        for a, b in zip(ref_hist, hist, strict=True):
            assert abs(a["loss"] - b["loss"]) < LOSS_TOL[name], (label, a, b)
            assert abs(a["roc_auc"] - b["roc_auc"]) < 5e-3, (label, a, b)
        assert set(ref_params) == set(params)
        worst = max(float(np.abs(ref_params[k] - params[k]).max()) for k in params)
        assert worst < 1e-3, (label, worst)


def test_in_step_draws_are_made_for_the_global_batch(mesh_run):
    from sparrowrecsys_torch.tools.dryrun_multichip import check_fit, fit_case

    ranks, _, _ = mesh_run
    single = fit_case(DIEN_RNG, None, "cpu")
    assert check_fit(single, ranks[0]["dien_rng"]) < 1e-3


def test_fit_collectives_are_counted(mesh_run):
    ranks, _, _ = mesh_run
    for r in ranks:
        cb = r["deepfm"]["collective_bytes"]
        assert cb["all-reduce"] > 0 and cb["all-gather"] > 0
        assert all(v == 0 for v in r["launches"].values())   # plain versions on the CPU


@pytest.mark.parametrize("case", ["split", "split_bf16"])
def test_small_leaf_split_by_whole_size(mesh_run, case):
    ranks, _, _ = mesh_run
    spec = {"split": SPLIT, "split_bf16": SPLIT_BF16}[case]
    jplan = jax_build_mesh(JaxMeshConfig(data_parallel=2, model_parallel=2),
                           devices=jax.devices()[:4])
    jt = JaxTrainer(jax_build("deepfm", user_buckets=8192, movie_buckets=1002),
                    JaxTrainConfig(**spec["config"]), plan=jplan)
    jparams = jt.init_params(synthetic_ctr_dataset(8, user_vocab=8192, movie_vocab=1002).features)
    jstate = jt.init_opt_state(jparams)
    want = sorted((tuple(m.shape), str(m.dtype)) for m in jstate.mu_big)
    want_params = sorted((tuple(p.shape), str(p.dtype)) for p in jax.tree_util.tree_leaves(jparams)
                         if p.size >= 65536)
    assert want == [((8192, 10), "bfloat16")]
    for r in ranks:
        got = r[case]
        assert sorted((tuple(v["whole"]), v["moment_dtype"]) for v in got.values()) == want
        assert sorted((tuple(v["whole"]), v["param_dtype"]) for v in got.values()) == want_params
        # The shard holds 40,960 elements, under the 65,536 split, and stays big.
        assert got["emb_userId.table"]["local"] == (4096, 10)


@pytest.mark.parametrize("name,sparse", [("deepfm", None), ("deepfm_v2", {"emb_userId": ("userId",)}),
                                         ("dien", None)])
def test_one_by_one_plan_bit_equal_to_no_plan(name, sparse):
    from sparrowrecsys_torch.data.negatives import add_dien_negatives as port_negatives
    from sparrowrecsys_torch.data.synthetic import synthetic_ctr_dataset as port_synthetic

    ds = port_synthetic(300, user_vocab=BUCKETS[0], movie_vocab=BUCKETS[1], seed=3)
    if name == "dien":
        ds = port_negatives(ds, seed=2020, vocab=BUCKETS[1])
    results = []
    for plan in (None, build_mesh(MeshConfig(data_parallel=1, model_parallel=1))):
        trainer = Trainer(_port_model(name), TrainConfig(**CFG), plan=plan, sparse_tables=sparse,
                          loss_fn=dien_loss_fn() if name == "dien" else None, device="cpu")
        trainer.min_rows_to_shard = 16
        results.append(trainer.fit(EncodedDataset(ds.features, ds.labels), verbose=False))
    a, b = results
    assert a.history == b.history
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)


def test_dist_bringup_twin():
    out = subprocess.run([sys.executable, "-m", "sparrowrecsys_torch.tools.dist_bringup"],
                         cwd=REPO, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stdout + out.stderr
    for line in ("DP BRINGUP OK", "MP BRINGUP OK", "resume_bitwise=True", "BRINGUP OK"):
        assert line in out.stdout, out.stdout


def test_measure_scaling_smoke():
    points = measure_scaling([1, 2], per_device_batch=64, steps=2, device="cpu")
    assert [p.n_devices for p in points] == [1, 2]
    assert all(p.examples_per_sec > 0 for p in points)
    assert points[0].efficiency == 1.0

"""Multi-device dry run: the twin of the JAX package's
`__graft_entry__.py::dryrun_multichip(n)` (:128-305).

    python -m sparrowrecsys_torch.tools.dryrun_multichip --devices 8 [--cuda]

Spawns n ranks (gloo on the CPU; NCCL with --cuda, one card per rank)
and asserts:
- sharded training equals single-device training for DeepFM and DIEN
  (2 epochs, batch 128, 512 synthetic rows, buckets 30,002/1,002, every
  table of at least 16 rows row-sharded) on an (n x 1) mesh and, where
  n >= 4 is even, an (n/2 x 2) mesh: per-epoch loss within 2e-3, ROC-AUC
  within 5e-3, every parameter within 1e-3 (the JAX dry run's bounds);
- `sharded_cosine_topk` equals `cosine_topk` on the 2-way model axis,
  raw and prepared (scores to rtol 1e-5, indices equal);
- the bytes each kind of collective moved in a sharded fit, counted by
  `parallel/collectives.py` (the counterpart of `_collective_bytes`).

`mesh_worker(plan, job, device)` is the rank side, shared with the tests
(`tests/test_torch_parallel.py`) and `chip_smoke.py`'s phase 9: it runs
a job's cases (fits, sharded lookups, sharded top-k, the optimizer's
leaf split) on its rank and returns what it found.
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, Optional

import numpy as np
import torch

BUCKETS = (30002, 1002)
MIN_ROWS = 16
FIT_CFG = dict(batch_size=128, epochs=2, shuffle_each_epoch=True, seed=11)
ROWS, DATA_SEED, NEG_SEED = 512, 3, 2020
#: The JAX dry run's bounds (`__graft_entry__.py:225-236`).
LOSS_TOL, AUC_TOL, PARAM_TOL = 2e-3, 5e-3, 1e-3


def kernel_launches() -> Dict[str, int]:
    """The six kernels' launch counts (each wrapper counts its launches)."""
    from sparrowrecsys_torch.ops.kernels import launch_counters

    return {k: fn.launches for k, fn in launch_counters().items()}


def case_data(case: Dict[str, Any]):
    """A fit case's EncodedDataset: its own columns, or synthetic rows
    (`generator`, `rows`, `seed`) with DIEN's negatives for a DIEN case."""
    from sparrowrecsys_torch.data import synthetic
    from sparrowrecsys_torch.data.dataset import EncodedDataset
    from sparrowrecsys_torch.data.negatives import add_dien_negatives

    if "features" in case:
        return EncodedDataset(dict(case["features"]), case["labels"])
    buckets = case.get("buckets", BUCKETS)
    gen = getattr(synthetic, case.get("generator", "synthetic_ctr_dataset"))
    ds = gen(case.get("rows", ROWS), user_vocab=buckets[0], movie_vocab=buckets[1],
             seed=case.get("seed", DATA_SEED))
    if case["model"] == "dien":
        ds = add_dien_negatives(ds, seed=NEG_SEED, vocab=buckets[1])
    return ds


def make_trainer(case: Dict[str, Any], plan, device):
    """The Trainer a fit case names: its model at `buckets`, TrainConfig
    fields, lazy row-Adam tables, DIEN's loss (drawing its negatives in
    the step with `in_graph_negatives`), `min_rows` to shard."""
    from sparrowrecsys_torch.config import TrainConfig
    from sparrowrecsys_torch.models import build_model
    from sparrowrecsys_torch.models.dien import dien_loss_fn
    from sparrowrecsys_torch.training.loop import Trainer

    buckets = case.get("buckets", BUCKETS)
    model = build_model(case["model"], user_buckets=buckets[0], movie_buckets=buckets[1],
                        **case.get("model_kwargs", {}))
    trainer = Trainer(model, TrainConfig(**{**FIT_CFG, **case.get("config", {})}), plan=plan,
                      loss_fn=(dien_loss_fn(in_graph_negatives=case.get("in_graph_negatives", False))
                               if case["model"] == "dien" else None),
                      sparse_tables=case.get("sparse_tables"), device=device)
    trainer.min_rows_to_shard = case.get("min_rows", MIN_ROWS)
    return trainer


def fit_case(case: Dict[str, Any], plan, device) -> Dict[str, Any]:
    """One fit from the case's initial params (whole; else the trainer's
    own) and row orders; the history, the whole params (numpy) and the
    bytes the fit's collectives moved."""
    trainer = make_trainer(case, plan, device)
    init = case.get("init")
    params = (None if init is None else
              {k: torch.from_numpy(np.asarray(v)) for k, v in init.items()})
    if plan is not None and plan.comm is not None:
        plan.comm.reset_counts()
    res = trainer.fit(case_data(case), params=params, orders=case.get("orders"),
                      verbose=False)
    comm = plan.comm if plan is not None else None
    return {"history": res.history,
            "params": {k: v.detach().float().cpu().numpy() for k, v in res.params.items()},
            "shardings": dict(trainer._shardings),
            "collective_bytes": dict(comm.bytes) if comm is not None else {},
            "examples_per_sec": res.examples_per_sec}


def lookup_case(case: Dict[str, Any], plan, device) -> Dict[str, Any]:
    """`sharded_lookup` of a whole table's row block at this rank's ids
    (the data coordinate's slice of `ids`), and the table's gradient of
    sum(out * cotangent) summed over `data` and gathered over `model`."""
    from sparrowrecsys_torch.ops.embedding import sharded_lookup

    table = np.asarray(case["table"], np.float32)
    v = table.shape[0]
    block = -(-v // plan.n_model)
    padded = np.zeros((block * plan.n_model, table.shape[1]), np.float32)
    padded[:v] = table
    m, d = plan.model_index, plan.data_index
    tb = torch.from_numpy(padded[m * block:(m + 1) * block]).to(device).requires_grad_()
    per = len(case["ids"]) // plan.n_data
    ids = torch.from_numpy(np.asarray(case["ids"])[d * per:(d + 1) * per]).to(device)
    cot = torch.from_numpy(np.asarray(case["cotangent"], np.float32)[d * per:(d + 1) * per])
    out = sharded_lookup(tb, ids, plan, rows=v)
    (out * cot.to(device)).sum().backward()
    grad = plan.all_reduce(tb.grad, plan.data_axis)
    grad = plan.all_gather(grad, plan.model_axis)[:v]
    return {"out": out.detach().cpu().numpy(), "grad": grad.cpu().numpy()}


def topk_case(case: Dict[str, Any], plan, device) -> Dict[str, Any]:
    """`sharded_cosine_topk` over `plan`'s model ranks, raw or prepared, with
    `cosine_topk` over the whole catalog on this rank beside it. The
    catalog is the case's, or `m` x `d` N(0, 1) rows drawn on the device
    from `seed` (with `q` queries)."""
    from sparrowrecsys_torch.ops.topk import cosine_topk, prepare_catalog, sharded_cosine_topk

    if "items" in case:
        items = torch.from_numpy(np.asarray(case["items"], np.float32)).to(device)
        queries = torch.from_numpy(np.asarray(case["queries"], np.float32)).to(device)
    else:
        gen = torch.Generator(device=device).manual_seed(case["seed"])
        items = torch.randn(case["m"], case["d"], generator=gen, device=device)
        queries = torch.randn(case["q"], case["d"], generator=gen, device=device)
    k = case["k"]
    cat = prepare_catalog(items) if case.get("prepared") else items
    s, i = sharded_cosine_topk(queries, cat, k, plan)
    s1, i1 = cosine_topk(queries, items, k)
    out = {"scores": s.cpu().numpy(), "indices": i.cpu().numpy(),
           "single_scores": s1.cpu().numpy(), "single_indices": i1.cpu().numpy()}
    if case.get("time_iters"):
        out["ms"] = _time_ms(lambda: sharded_cosine_topk(queries, cat, k, plan),
                             case["time_iters"], plan, device)
        out["single_ms"] = _time_ms(lambda: cosine_topk(queries, items, k),
                                    case["time_iters"], plan, device)
    return out


def _time_ms(fn, iters: int, plan, device) -> float:
    """ms per call of `fn`, the ranks in step, after one warm-up call."""
    import time

    fn()
    plan.barrier()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) * 1e3 / iters


def split_case(case: Dict[str, Any], plan, device) -> Dict[str, Any]:
    """Which leaves the optimizer keeps per leaf (big) and in what dtype
    their moments are, with their whole and local shapes."""
    from sparrowrecsys_torch.training.optim import split_leaves

    trainer = make_trainer(case, plan, device)
    params, opt = trainer.prepare(trainer.init_params())
    _, big = split_leaves(params, trainer.tx.small_max_elems, trainer.tx.leaf_sizes)
    return {k: {"whole": trainer._whole_shapes[k], "local": tuple(params[k].shape),
                "moment_dtype": str(mu.dtype).replace("torch.", ""),
                "param_dtype": str(params[k].dtype).replace("torch.", "")}
            for k, mu in zip(big, opt.mu_big)}


CASES = {"fit": fit_case, "lookup": lookup_case, "topk": topk_case, "split": split_case}


def mesh_worker(plan, job, device: Optional[str] = "cpu") -> Dict[str, Any]:
    """Run each (name, kind, case) of `job` on this rank. Returns
    {name: result} (fits: only rank 0 keeps the params), the launches of
    the six kernels in the whole job, and this rank's coordinates."""
    from sparrowrecsys_torch.ops import kernels

    if device is not None and torch.device(device).type == "cuda":
        kernels.library()
    before = kernel_launches()
    out: Dict[str, Any] = {}
    for name, kind, case in job:
        res = CASES[kind](case, plan, device)
        if kind == "fit" and plan.rank != 0:
            res = {k: v for k, v in res.items() if k != "params"}
        out[name] = res
    after = kernel_launches()
    out["launches"] = {k: after[k] - before[k] for k in after}
    out["coords"] = (plan.rank, plan.data_index, plan.model_index)
    return out


# ---- the dry run -----------------------------------------------------------------

def max_gap(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> float:
    return max(float(np.max(np.abs(np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64))))
               for k in a)


def check_fit(single: Dict[str, Any], sharded: Dict[str, Any], loss_tol: float = LOSS_TOL,
              auc_tol: float = AUC_TOL, param_tol: float = PARAM_TOL) -> float:
    """Assert a sharded fit lands on a single-device one; returns the worst
    parameter gap."""
    for a, b in zip(single["history"], sharded["history"], strict=True):
        if not np.isfinite(b["loss"]):
            raise AssertionError(f"sharded loss {b['loss']}")
        if abs(a["loss"] - b["loss"]) >= loss_tol or abs(a["roc_auc"] - b["roc_auc"]) >= auc_tol:
            raise AssertionError(f"history {a} != {b}")
    worst = max_gap(single["params"], sharded["params"])
    if not worst < param_tol:
        raise AssertionError(f"max |dparam| {worst} >= {param_tol}")
    return worst


def dryrun_multichip(n_devices: int, device: str = "cpu") -> list:
    """The dry run over `n_devices` ranks; returns its assertion lines."""
    from sparrowrecsys_torch.parallel.scaling import spawn_ranks

    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    meshes = [(n_devices, 1)]
    if n_devices % 2 == 0 and n_devices >= 4:
        meshes.append((n_devices // 2, 2))
    cases = {name: {"model": name} for name in ("deepfm", "dien")}
    singles = {}
    for name, case in cases.items():
        trainer = make_trainer(case, None, device)
        case["init"] = {k: v.cpu().numpy() for k, v in trainer.init_params().items()}
        singles[name] = fit_case(case, None, device)
    rng = np.random.default_rng(0)
    topk = {"items": rng.normal(size=(1003, 16)).astype(np.float32),
            "queries": rng.normal(size=(5, 16)).astype(np.float32), "k": 7}
    checks = []
    for dp, mp in meshes:
        job = [(name, "fit", case) for name, case in cases.items()]
        if mp == 2:
            job += [("topk_raw", "topk", topk), ("topk_prepared", "topk", {**topk, "prepared": True})]
        ranks = spawn_ranks(mesh_worker, (dp, mp), (job, device), backend=backend)
        rank0 = ranks[0]
        for name in cases:
            worst = check_fit(singles[name], rank0[name])
            checks.append(f"{name} {dp}x{mp}: loss/auc/params == single-device "
                          f"(max|dparam|={worst:.2e})")
        if mp == 2:
            for r in ranks:
                for kind in ("topk_raw", "topk_prepared"):
                    t = r[kind]
                    np.testing.assert_allclose(t["scores"], t["single_scores"], rtol=1e-5)
                    np.testing.assert_array_equal(t["indices"], t["single_indices"])
            checks.append(f"sharded_cosine_topk {dp}x{mp} == exact (raw + prepared catalog)")
            cb = rank0["deepfm"]["collective_bytes"]
            checks.append("deepfm sharded fit's collectives on rank 0: " + ", ".join(
                f"{k}={v / 1e6:.2f}MB" for k, v in sorted(cb.items())))
    for line in checks:
        print("dryrun assertion:", line)
    print(f"dryrun_multichip ok: {len(checks)} assertions over meshes "
          + ", ".join(f"{dp}x{mp}" for dp, mp in meshes)
          + "; cross-process save/resume: sparrowrecsys_torch.tools.dist_bringup")
    return checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--cuda", action="store_true", help="one card per rank, NCCL")
    args = ap.parse_args(argv)
    dryrun_multichip(args.devices, "cuda" if args.cuda else "cpu")
    return 0


if __name__ == "__main__":
    sys.exit(main())

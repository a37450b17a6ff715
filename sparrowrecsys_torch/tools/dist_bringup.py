"""Multi-process bring-up: the twin of the JAX package's
`tools/dist_bringup.py`.

    python -m sparrowrecsys_torch.tools.dist_bringup [--cuda]

Spawns its ranks itself (`parallel.scaling.spawn_ranks`: one OS process
per rank, gloo on the CPU, a `file://` rendezvous in a temporary
directory, one CPU thread each) and drives the real training path:

Phase DP: a 2x1 data mesh over 2 processes. Each rank feeds only its half
of a 64-row global batch (`host_local_batch`) into one DeepFM train step;
the replicated parameters must come out identical on both ranks.

Phase MP: a 2x2 (data x model) mesh over 4 processes, DeepFM at 30,002 /
1,002 buckets with the user table row-sharded across the process
boundary (the name rule at its default 4,096 rows; the movie table stays
replicated). Two epochs of one step (batch 64): once uninterrupted, once
saved after step 1 (gathered to rank 0, written in the single-device
layout) and resumed in a fresh Trainer (re-sharded); the final params
must be bitwise equal, and within 1e-3 of the same fit on one device in
this process.

Prints `DP BRINGUP OK`, `MP BRINGUP OK` (with `resume_bitwise=True`) and
`BRINGUP OK`; exits 1 on a failure. `--cuda` runs the ranks on cards
(NCCL, one card per rank).
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import tempfile

import numpy as np
import torch

DP_BATCH = 64
MP_BUCKETS = (30002, 1002)
MP_BATCH = 64
MP_EPOCHS = 2
SEED = 7


def _digest(params) -> float:
    return float(sum(v.detach().double().abs().sum() for v in params.values()))


def worker_dp(plan, device):
    import torch.distributed as dist

    from sparrowrecsys_torch.config import TrainConfig
    from sparrowrecsys_torch.data.synthetic import synthetic_ctr_dataset
    from sparrowrecsys_torch.models import build_model
    from sparrowrecsys_torch.ops import metrics as M
    from sparrowrecsys_torch.parallel.scaling import host_local_batch
    from sparrowrecsys_torch.training.loop import Trainer

    assert dist.get_world_size() == 2 and (plan.n_data, plan.n_model) == (2, 1)
    trainer = Trainer(build_model("deepfm"), TrainConfig(batch_size=DP_BATCH, epochs=1, seed=SEED),
                      plan=plan, device=device)
    ds = synthetic_ctr_dataset(DP_BATCH, seed=11)
    per = DP_BATCH // plan.n_data
    lo = plan.data_index * per
    feats = host_local_batch({k: v[lo:lo + per] for k, v in ds.features.items()}, plan,
                             trainer.device)
    labels = torch.from_numpy(ds.labels[lo:lo + per]).to(trainer.device)
    params, opt_state = trainer.prepare(trainer.init_params())
    params, opt_state, mstate = trainer._train_step(
        params, opt_state, M.init_metrics(trainer.device), feats, labels,
        torch.ones_like(labels))
    mstate = trainer._metrics_over_data(mstate)
    whole = trainer.whole_params(params, opt_state)
    return {"digest": _digest(whole), "loss": M.finalize_metrics(mstate)["loss"]}


def _mp_trainer(plan, device):
    from sparrowrecsys_torch.config import TrainConfig
    from sparrowrecsys_torch.models import build_model
    from sparrowrecsys_torch.training.loop import Trainer

    model = build_model("deepfm", user_buckets=MP_BUCKETS[0], movie_buckets=MP_BUCKETS[1])
    return Trainer(model, TrainConfig(batch_size=MP_BATCH, epochs=MP_EPOCHS, seed=SEED),
                   plan=plan, device=device)


def _mp_data():
    from sparrowrecsys_torch.data.synthetic import synthetic_ctr_dataset

    return synthetic_ctr_dataset(MP_BATCH, user_vocab=MP_BUCKETS[0],
                                 movie_vocab=MP_BUCKETS[1], seed=11)


def worker_mp(plan, device, state_root):
    assert (plan.n_data, plan.n_model) == (2, 2)
    ds = _mp_data()
    trainer = _mp_trainer(plan, device)
    init = trainer.init_params()
    unint = trainer.fit(ds, params=init, verbose=False).params
    assert trainer._shardings["emb_userId.table"] == (plan.model_axis, None)
    assert trainer._shardings["emb_movieId.table"] == ()

    state_dir = os.path.join(state_root, "mp_state")
    _mp_trainer(plan, device).fit(ds, params=init, epochs=1, state_dir=state_dir,
                                  verbose=False)
    resumed = _mp_trainer(plan, device).fit(ds, params=init, state_dir=state_dir,
                                            resume=True, verbose=False).params
    bitwise = all(torch.equal(unint[k], resumed[k]) for k in unint)
    h = hashlib.sha256()
    for k in sorted(unint):
        h.update(unint[k].detach().cpu().contiguous().numpy().tobytes())
    out = {"bitwise": bitwise, "sha": h.hexdigest()[:16]}
    if plan.rank == 0:
        out["params"] = {k: v.detach().cpu().numpy() for k, v in unint.items()}
    return out


def single_reference(device):
    """The phase-MP fit on one device (no plan), whole params as numpy."""
    trainer = _mp_trainer(None, device)
    res = trainer.fit(_mp_data(), params=trainer.init_params(), verbose=False)
    return {k: v.detach().cpu().numpy() for k, v in res.params.items()}


def main(argv=None) -> int:
    from sparrowrecsys_torch.parallel.scaling import spawn_ranks

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cuda", action="store_true", help="one card per rank, NCCL")
    args = ap.parse_args(argv)
    device, backend = ("cuda", "nccl") if args.cuda else ("cpu", "gloo")

    # --- phase DP --------------------------------------------------------
    ranks = spawn_ranks(worker_dp, (2, 1), (device,), backend=backend)
    for r, out in enumerate(ranks):
        print(f"WORKER {r} digest={out['digest']:.6f} loss={out['loss']:.6f}")
    digests = {out["digest"] for out in ranks}
    if len(digests) != 1 or not all(np.isfinite(out["loss"]) for out in ranks):
        print(f"BRINGUP FAILED: divergent params {sorted(digests)}")
        return 1
    print(f"DP BRINGUP OK: 2 processes on a 2x1 data mesh, replicated params agree "
          f"({ranks[0]['digest']:.6f})")

    # --- phase MP: 2x2 mesh + row-sharded table + save/resume -----------
    with tempfile.TemporaryDirectory() as root:
        ranks = spawn_ranks(worker_mp, (2, 2), (device, root), backend=backend)
    for r, out in enumerate(ranks):
        print(f"MPWORKER {r} sharded_user_table=True resume_bitwise={out['bitwise']} "
              f"sha={out['sha']}")
    if not all(out["bitwise"] for out in ranks):
        print("BRINGUP FAILED: resumed trajectory diverged from the uninterrupted one")
        return 1
    if len({out["sha"] for out in ranks}) != 1:
        print("BRINGUP FAILED: divergent mp params")
        return 1
    ref = single_reference(device)
    got = ranks[0]["params"]
    worst = max(float(np.max(np.abs(ref[k] - got[k]))) for k in ref)
    if not worst < 1e-3:
        print(f"BRINGUP FAILED: sharded != single-device (max {worst})")
        return 1
    print("MP BRINGUP OK: 2x2 data x model mesh over 4 processes, user table row-sharded, "
          "save/resume across the process boundary resume_bitwise=True, parity vs "
          f"single-device max|dparam|={worst:.2e}")
    print("BRINGUP OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())

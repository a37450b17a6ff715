"""Do DIN and DIEN extract sequential signal? The port of
`tools/seq_signal.py`.

Trains the zoo on generators of `data/synthetic.py` and scores each fit
on a held-out slice:

- `sequence`: the label depends only on a recency-decayed planted
  compatibility between the history and the candidate (no marginal
  signal). Expected: oracle > DIEN >= DIN >> DeepFM == EmbeddingMLP ==
  0.5 (no history channel).
- `drift`: the label depends on the last of a drifting taste, which the
  history observes step by step (`drift_ctr_with_oracle`).
- `marginal`: the signal lives in per-row numerics; every model ties.

The held-out AUC is the exact (Mann-Whitney) AUC of `Trainer.evaluate`;
the oracle row scores the planted logit on the same test slice. Each fit's
row order comes from the Trainer's torch.Generator seeded with the fit's
seed (the JAX package's `jax.random` orders do not replay in torch), so a
model's AUC is compared with the JAX tool's as a result, not bit for bit.

    python -m sparrowrecsys_torch.tools.seq_signal [--n 2000000] [--seeds 3]
        [--epochs 3] [--models embedding_mlp,deepfm,din,dien]
        [--datasets sequence,marginal] [--json-out F] [--cpu]

The JAX tool's arguments and defaults, but `--json-out` writes nothing
unless given a path (the JAX tool's default, `seq_signal.json`, is the
committed record of its TPU run); the file has `seq_signal.json`'s keys.
Runs on the CUDA device unless `--cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Optional

import numpy as np


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2_000_000, help="train rows")
    ap.add_argument("--test-n", type=int, default=500_000)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=8192)
    ap.add_argument("--models", default="embedding_mlp,deepfm,din,dien")
    ap.add_argument("--datasets", default="sequence,marginal")
    ap.add_argument("--json-out", default="")
    ap.add_argument("--t", type=int, default=5,
                    help="generator history length (userRatedMovie1..t)")
    ap.add_argument("--model-t", type=int, default=0,
                    help="history length DIN/DIEN read; 0 = --t")
    ap.add_argument("--compat-dim", type=int, default=4)
    ap.add_argument("--gain", type=float, default=4.0)
    ap.add_argument("--recency", type=float, default=0.6)
    ap.add_argument("--markov-tau", type=float, default=1.5)
    ap.add_argument("--dien-aux", default="paper", choices=("paper", "none", "reference"))
    ap.add_argument("--dien-alpha", type=float, default=0.5)
    ap.add_argument("--dien-aux-norm", default="sum", choices=("sum", "mean"))
    ap.add_argument("--drift-rho", type=float, default=0.9)
    ap.add_argument("--drift-tau", type=float, default=2.0)
    ap.add_argument("--dien-remat", default="auto", choices=("auto", "on", "off"))
    ap.add_argument("--dataset-cache", default="",
                    help="npz path: load the generated dataset from it if present, "
                    "else generate and save it there")
    ap.add_argument("--cpu", action="store_true", help="train on the CPU")
    return ap


def _generate(args, name: str, total: int):
    """(EncodedDataset, oracle logits or None) of generator `name`."""
    from sparrowrecsys_torch.data.dataset import EncodedDataset
    from sparrowrecsys_torch.data.synthetic import (
        drift_ctr_with_oracle,
        sequence_ctr_with_oracle,
        synthetic_ctr_dataset,
    )

    if name == "marginal":
        return synthetic_ctr_dataset(total, seed=7), None
    cache = args.dataset_cache
    if cache and os.path.exists(cache):
        z = np.load(cache)
        feats = {k: z[k] for k in z.files if not k.startswith("__")}
        print(f"dataset cache hit: {cache}", flush=True)
        return EncodedDataset(feats, z["__labels__"]), z["__oracle__"]
    if name == "drift":
        full, oracle = drift_ctr_with_oracle(
            total, seed=7, t=args.t, compat_dim=args.compat_dim, gain=args.gain,
            drift_rho=args.drift_rho, tau=args.drift_tau)
    elif name == "sequence":
        full, oracle = sequence_ctr_with_oracle(
            total, seed=7, t=args.t, compat_dim=args.compat_dim, gain=args.gain,
            recency=args.recency, markov_tau=args.markov_tau)
    else:
        raise ValueError(f"unknown dataset {name!r}")
    if cache:
        np.savez(cache, __oracle__=oracle, __labels__=full.labels, **full.features)
        print(f"dataset cache written: {cache}", flush=True)
    return full, oracle


def fit_one(args, name: str, seed: int, train_ds, test_ds, device) -> float:
    """The exact held-out ROC-AUC of `name` trained on `train_ds`."""
    from sparrowrecsys_torch.config import TrainConfig
    from sparrowrecsys_torch.data.negatives import add_dien_negatives
    from sparrowrecsys_torch.models import build_model
    from sparrowrecsys_torch.models.dien import dien_loss_fn
    from sparrowrecsys_torch.training.loop import Trainer

    model_t = args.model_t or args.t
    loss_fn = None
    if name == "din":
        model = build_model(name, recent_movies=model_t)
    elif name == "dien":
        train_ds = add_dien_negatives(train_ds, seed=2020 + seed, recent_movies=model_t)
        test_ds = add_dien_negatives(test_ds, seed=2021 + seed, recent_movies=model_t)
        model = build_model(
            name, recent_movies=model_t, aux_mode=args.dien_aux, alpha=args.dien_alpha,
            aux_norm=args.dien_aux_norm,
            recurrence_remat={"auto": None, "on": True, "off": False}[args.dien_remat])
        loss_fn = dien_loss_fn(alpha=args.dien_alpha, aux_mode=args.dien_aux)
    else:
        model = build_model(name)
    cfg = TrainConfig(batch_size=args.batch_size, epochs=args.epochs, seed=seed)
    trainer = Trainer(model, cfg, loss_fn=loss_fn, device=device)
    res = trainer.fit(train_ds, test=test_ds, verbose=False)
    return float(res.eval_metrics["roc_auc"])


def run(args, log: Callable[[str], None] = print, device: Optional[str] = None) -> dict:
    """The tool's JSON document, {"config": ..., "results": ...}."""
    from sparrowrecsys_torch.data.dataset import EncodedDataset
    from sparrowrecsys_torch.ops.metrics import exact_auc

    device = device or ("cpu" if args.cpu else "cuda")
    total = args.n + args.test_n
    results = {}
    for dname in args.datasets.split(","):
        full, oracle = _generate(args, dname, total)
        train_ds = EncodedDataset(*full.slice(np.arange(args.n)))
        test_ds = EncodedDataset(*full.slice(np.arange(args.n, total)))
        oracle_auc = None
        if oracle is not None:
            probs = 1 / (1 + np.exp(-oracle[args.n:]))
            oracle_auc = exact_auc(probs, test_ds.labels)["roc_auc"]
        rows = {}
        for name in args.models.split(","):
            aucs = []
            for seed in range(args.seeds):
                t0 = time.perf_counter()
                aucs.append(fit_one(args, name, seed, train_ds, test_ds, device))
                log(f"{dname}/{name} seed {seed}: roc={aucs[-1]:.4f} "
                    f"({time.perf_counter() - t0:.1f}s)")
            a = np.asarray(aucs)
            rows[name] = {"mean": float(a.mean()), "std": float(a.std()),
                          "seeds": [float(x) for x in aucs]}
        results[dname] = {"models": rows, "oracle_roc_auc": oracle_auc}
        if oracle_auc is not None:
            log(f"{dname} oracle roc: {oracle_auc:.4f}")
    config = {
        "train_rows": args.n, "test_rows": args.test_n, "seeds": args.seeds,
        "epochs": args.epochs, "batch_size": args.batch_size, "planted_seed": 7,
        "compat_dim": args.compat_dim, "gain": args.gain, "recency": args.recency,
        "markov_tau": args.markov_tau, "t": args.t, "model_t": args.model_t or args.t,
        "dien_aux": args.dien_aux, "dien_alpha": args.dien_alpha,
        "dien_aux_norm": args.dien_aux_norm, "dien_remat": args.dien_remat,
        "drift_rho": args.drift_rho, "drift_tau": args.drift_tau, "models": args.models,
        "device": str(device),
    }
    return {"config": config, "results": results}


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    doc = run(args, log=lambda m: print(m, flush=True))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(doc, f, indent=1)
    print(json.dumps(doc["results"], indent=1))
    return doc


if __name__ == "__main__":
    main()

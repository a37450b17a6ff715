"""The AUC parity protocol of `PARITY.md` (`tools/parity.py`), run in the
port: every zoo model trained on the bundled samples for the pinned seeds
at the reference's recipe (batch 12, 5 epochs, Adam 1e-3, eps 1e-7), and
each model's mean test metrics printed beside the JAX package's band.

    python -m sparrowrecsys_torch.tools.parity [--seeds 10] [--models deepfm,din]
        [--epochs 5] [--batch-size 12] [--cpu] [--json-out FILE]

On the card unless --cpu. The port draws its initial weights from torch
generators, not from `jax.random`, so one seed's run is not the JAX run of
that seed: the tool holds each model's mean over the seeds to the band
(mean +/- 2 std of the JAX package's seeds), not each seed. It exits 1 when
a model's mean ROC-AUC falls outside its band. Not part of the tests: a
full run is 80 fits of 1,640 steps each.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import numpy as np

MODELS = ("deepfm", "deepfm_v2", "dien", "din", "embedding_mlp", "neuralcf",
          "neuralcf_two_tower", "wide_deep")
METRICS = ("loss", "accuracy", "roc_auc", "pr_auc")
_ROW = re.compile(r"^\|\s*(\w+)\s*\|" + r"\s*([-\d.]+) ± ([-\d.]+)\s*\|" * 4)


def read_bands(path: str) -> dict:
    """{model: {metric: (mean, std)}} from PARITY.md's band table."""
    bands = {}
    with open(path) as f:
        for line in f:
            m = _ROW.match(line.strip())
            if m:
                nums = [float(x) for x in m.groups()[1:]]
                bands[m.group(1)] = {k: (nums[2 * i], nums[2 * i + 1])
                                     for i, k in enumerate(METRICS)}
    return bands


def run_model(name, seeds, epochs, batch_size, device, train_ds, test_ds):
    """Test metrics of one fit per seed."""
    from sparrowrecsys_torch.config import TrainConfig
    from sparrowrecsys_torch.data.negatives import add_dien_negatives
    from sparrowrecsys_torch.models import build_model
    from sparrowrecsys_torch.models.dien import dien_loss_fn
    from sparrowrecsys_torch.training.loop import Trainer

    per_seed = []
    for seed in seeds:
        tr, te, loss_fn = train_ds, test_ds, None
        if name == "dien":
            tr = add_dien_negatives(train_ds, seed=2020 + seed)
            te = add_dien_negatives(test_ds, seed=2021 + seed)
            loss_fn = dien_loss_fn()
        cfg = TrainConfig(batch_size=batch_size, epochs=epochs, seed=seed)
        t0 = time.perf_counter()
        trainer = Trainer(build_model(name), cfg, loss_fn=loss_fn, device=device)
        res = trainer.fit(tr, test=te, verbose=False)
        m = dict(res.eval_metrics, wall_s=time.perf_counter() - t0,
                 examples_per_sec=res.examples_per_sec)
        per_seed.append(m)
        print(f"{name} seed {seed}: roc={m['roc_auc']:.4f} pr={m['pr_auc']:.4f} "
              f"loss={m['loss']:.4f} ({m['wall_s']:.1f} s)", flush=True)
    return per_seed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=12)
    ap.add_argument("--models", default=",".join(MODELS))
    ap.add_argument("--cpu", action="store_true", help="train on the CPU instead of cuda")
    ap.add_argument("--parity-md", default=None, help="the bands; default <repo>/PARITY.md")
    ap.add_argument("--json-out", default=None, help="write the per-seed numbers here")
    args = ap.parse_args(argv)

    from sparrowrecsys_torch.config import DataConfig
    from sparrowrecsys_torch.data.dataset import encode_samples, load_samples
    from sparrowrecsys_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    bands = read_bands(args.parity_md or os.path.join(repo, "PARITY.md"))
    data = DataConfig()
    train_ds = encode_samples(load_samples(data.path("trainingSamples.csv")))
    test_ds = encode_samples(load_samples(data.path("testSamples.csv")))
    name = "cpu" if device.type == "cpu" else __import__("torch").cuda.get_device_name(device)
    print(f"device: {name}; {len(train_ds)} train / {len(test_ds)} test rows; "
          f"seeds 0-{args.seeds - 1}, {args.epochs} epochs, batch {args.batch_size}", flush=True)

    results, outside = {}, []
    for model in args.models.split(","):
        per_seed = run_model(model, range(args.seeds), args.epochs, args.batch_size, device,
                             train_ds, test_ds)
        summary = {k: (float(np.mean([s[k] for s in per_seed])),
                       float(np.std([s[k] for s in per_seed]))) for k in METRICS}
        results[model] = {"seeds": per_seed, "summary": summary}
        band = bands.get(model)
        cells = []
        for k in METRICS:
            mean, std = summary[k]
            ref = f" (band {band[k][0]:.4f} ± {band[k][1]:.4f})" if band else ""
            cells.append(f"{k} {mean:.4f} ± {std:.4f}{ref}")
        verdict = "no band"
        if band:
            lo = band["roc_auc"][0] - 2 * band["roc_auc"][1]
            hi = band["roc_auc"][0] + 2 * band["roc_auc"][1]
            inside = lo <= summary["roc_auc"][0] <= hi
            verdict = "mean ROC-AUC in band" if inside else f"mean ROC-AUC outside [{lo:.4f}, {hi:.4f}]"
            if not inside:
                outside.append(model)
        print(f"[parity] {model}: " + "; ".join(cells) + f" -> {verdict}", flush=True)

    if args.json_out:
        os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump({"device": name, "seeds": args.seeds, "epochs": args.epochs,
                       "batch_size": args.batch_size, "results": results}, f, indent=1)
    return 1 if outside else 0


if __name__ == "__main__":
    sys.exit(main())

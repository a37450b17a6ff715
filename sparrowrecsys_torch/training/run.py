"""Command-line training: the port of `sparrowrecsys_tpu/training/run.py`.

    python -m sparrowrecsys_torch.training.run --model din --epochs 1 [--cpu]

Loads the bundled samples (or --train/--test CSVs in the reference's
27-column format), trains any of the eight zoo models on the card (the
CPU with --cpu), prints loss/accuracy/ROC-AUC/PR-AUC, optionally exports
a versioned checkpoint the serving plane (either package) loads, and
shows 12 sample predictions like the reference scripts
(`EmbeddingMLP.py:101-105`). DIEN trains on the samples with its negative
history columns added (seeds 2020 for train, 2021 for test, as the
reference's) and with `dien_loss_fn()`.

--config FILE takes the `data` and `train` sections of a config file
either package's `config_to_json` wrote (flags given on the command line
take precedence). --state-dir DIR checkpoints the whole train state there
every --checkpoint-every epochs, in the JAX package's format; --resume
continues from the newest state there (a JAX-written one too).
"""

from __future__ import annotations

import argparse
import dataclasses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="deepfm",
                    help="embedding_mlp, wide_deep, neuralcf, neuralcf_two_tower, "
                    "deepfm, deepfm_v2, din or dien")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--parity", action="store_true",
                    help="reference-parity settings (batch=12)")
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--train", default=None, help="trainingSamples.csv path")
    ap.add_argument("--test", default=None, help="testSamples.csv path")
    ap.add_argument("--standardize", action="store_true",
                    help="z-score numerics with train stats (non-parity)")
    ap.add_argument("--config", default=None,
                    help="JSON config file (config_from_json); flags take precedence")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--export", default=None, metavar="DIR",
                    help="export a versioned checkpoint: DIR/NNN/params.msgpack + meta.json")
    ap.add_argument("--state-dir", default=None, metavar="DIR",
                    help="checkpoint the whole train state (params, Adam moments, "
                    "the next epoch) here every --checkpoint-every epochs")
    ap.add_argument("--checkpoint-every", type=int, default=1)
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest state under --state-dir and continue")
    ap.add_argument("--cpu", action="store_true", help="train on the CPU instead of cuda")
    args = ap.parse_args(argv)

    from sparrowrecsys_torch.config import DataConfig, TrainConfig, config_from_json
    from sparrowrecsys_torch.data.dataset import encode_samples, load_samples, standardize
    from sparrowrecsys_torch.data.negatives import add_dien_negatives
    from sparrowrecsys_torch.models import build_model
    from sparrowrecsys_torch.models.dien import dien_loss_fn
    from sparrowrecsys_torch.training.checkpoint import params_to_flax, save
    from sparrowrecsys_torch.training.loop import Trainer

    file_cfg = config_from_json(args.config) if args.config else None
    if args.data_root is not None:
        data = DataConfig(data_root=args.data_root)
    else:
        data = file_cfg.data if file_cfg else DataConfig()
    train_ds = encode_samples(load_samples(args.train or data.path("trainingSamples.csv")))
    test_ds = encode_samples(load_samples(args.test or data.path("testSamples.csv")))
    if args.standardize:
        train_ds, test_ds = standardize(train_ds, test_ds)
    print(f"train={len(train_ds)} test={len(test_ds)} model={args.model}")
    loss_fn = None
    if args.model == "dien":
        train_ds = add_dien_negatives(train_ds, seed=2020)
        test_ds = add_dien_negatives(test_ds, seed=2021)
        loss_fn = dien_loss_fn()

    base = file_cfg.train if file_cfg else TrainConfig()
    overrides = {"batch_size": args.batch_size or (12 if args.parity else base.batch_size)}
    if args.epochs is not None:
        overrides["epochs"] = args.epochs
    if args.lr is not None:
        overrides["learning_rate"] = args.lr
    if args.seed is not None:
        overrides["seed"] = args.seed
    cfg = dataclasses.replace(base, **overrides)
    model = build_model(args.model)
    trainer = Trainer(model, cfg, loss_fn=loss_fn, device="cpu" if args.cpu else None)
    result = trainer.fit(train_ds, test=test_ds, state_dir=args.state_dir,
                         checkpoint_every=args.checkpoint_every, resume=args.resume)

    if args.export:
        vdir = save(params_to_flax(result.params, model), args.export,
                    meta={"model": args.model, "metrics": result.eval_metrics},
                    keep=cfg.checkpoint_keep)
        print(f"exported checkpoint: {vdir}")

    probs = trainer.predict(result.params, test_ds)[:12]
    for p, label in zip(probs, test_ds.labels[:12]):
        print(f"Predicted good rating: {p:.2%}  | Actual rating label: "
              + ("Good Rating" if label > 0.5 else "Bad Rating"))
    print(f"throughput: {result.examples_per_sec:.0f} examples/s")


if __name__ == "__main__":
    main()

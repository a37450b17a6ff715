"""The offline feature job: the port of `sparrowrecsys_tpu/data/run.py`
(`FeatureEngForRecModel.main`, `FeatureEngForRecModel.scala:299-342`).

    python -m sparrowrecsys_torch.data.run [--out-dir DIR]
        [--sample-fraction 1.0] [--by-time] [--export-features]

ratings.csv + movies.csv -> label, movie features and windowed user
features (all 27 columns) -> split -> trainingSamples.csv and
testSamples.csv in the reference format; `--export-features` also writes
the `mf:`/`uf:` feature-store hand-off, feature_store.json. numpy on the
host: the job runs no model and needs no card.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--sample-fraction", type=float, default=1.0)
    ap.add_argument("--train-fraction", type=float, default=0.8)
    ap.add_argument("--by-time", action="store_true")
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--export-features", action="store_true")
    ap.add_argument("--native", action="store_true",
                    help="the C++ ratings loader: not ported (raises)")
    args = ap.parse_args(argv)
    if args.native:
        raise NotImplementedError(
            "--native (the repo-root C++ ratings loader) is not ported; it is queued in "
            "ROADMAP.md. The numpy loader reads the same file.")

    from sparrowrecsys_torch.config import GENRE_VOCAB, DataConfig
    from sparrowrecsys_torch.data.feature_pipeline import build_samples, split_samples
    from sparrowrecsys_torch.data.movielens import load_movies, load_ratings

    data = DataConfig() if args.data_root is None else DataConfig(data_root=args.data_root)
    out_dir = args.out_dir or data.data_root
    catalog = load_movies(data.path(data.movies_csv))
    ratings = load_ratings(data.path(data.ratings_csv))
    print(f"{len(catalog)} movies, {len(ratings)} ratings")

    table = build_samples(ratings, catalog)
    print(f"{len(table)} samples after userRatingCount>1 filter")
    train, test = split_samples(table, sample_fraction=args.sample_fraction,
                                train_fraction=args.train_fraction, by_time=args.by_time,
                                seed=args.seed)
    os.makedirs(out_dir, exist_ok=True)
    train.to_csv(os.path.join(out_dir, "trainingSamples.csv"), GENRE_VOCAB)
    test.to_csv(os.path.join(out_dir, "testSamples.csv"), GENRE_VOCAB)
    print(f"wrote {len(train)} train / {len(test)} test rows to {out_dir}")

    if args.export_features:
        from sparrowrecsys_torch.serving.feature_store import (
            FeatureStore,
            export_sample_features,
        )

        store = FeatureStore()
        export_sample_features(table, GENRE_VOCAB, store)
        path = os.path.join(out_dir, "feature_store.json")
        store.save(path)
        print(f"wrote feature store handoff: {path}")


if __name__ == "__main__":
    main()

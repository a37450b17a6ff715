"""The embedding pretraining job (`Embedding.main`,
Embedding.scala:313-334), the port of `sparrowrecsys_tpu/embedding/run.py`:

    python -m sparrowrecsys_torch.embedding.run [--graph-emb] [--user-emb]
        [--epochs N] [--data-root DIR] [--ratings CSV] [--out-dir DIR] [--cpu]

Trains item2vec over the watch sequences and writes `item2vecEmb.csv` in
the reference's `id:vec` format, prints the findSynonyms("158", 20) and
LSH demos; `--graph-emb` adds DeepWalk (`itemGraphEmb.csv`, at the shipped
`DeepWalkConfig` whatever `--epochs` says, as the JAX job), `--user-emb`
the user embeddings (`userEmb.csv`). The output directory defaults to
`<data root>/modeldata`, the files the server's `emb` paths read. It runs
on the CUDA device; `--cpu` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--ratings", default=None)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--graph-emb", action="store_true")
    ap.add_argument("--user-emb", action="store_true")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU; the default is the CUDA device")
    args = ap.parse_args(argv)

    from sparrowrecsys_torch.config import DataConfig
    from sparrowrecsys_torch.data.movielens import load_ratings
    from sparrowrecsys_torch.embedding.artifacts import write_embeddings_csv
    from sparrowrecsys_torch.embedding.deepwalk import DeepWalkConfig, train_deepwalk
    from sparrowrecsys_torch.embedding.item2vec import (
        Item2VecConfig,
        find_synonyms,
        train_item2vec,
    )
    from sparrowrecsys_torch.embedding.lsh import LSHIndex
    from sparrowrecsys_torch.embedding.user_emb import generate_user_emb
    from sparrowrecsys_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    data = DataConfig() if args.data_root is None else DataConfig(data_root=args.data_root)
    ratings_path = args.ratings or data.path(data.ratings_csv)
    out_dir = args.out_dir or os.path.join(data.data_root, "modeldata")
    ratings = load_ratings(ratings_path)
    print(f"ratings: {len(ratings)} events")

    cfg = Item2VecConfig(epochs=args.epochs)
    vocab, emb = train_item2vec(ratings, cfg, device=device)
    print(f"item2vec: {len(vocab)} items x {emb.shape[1]}d on {device}")
    write_embeddings_csv(os.path.join(out_dir, "item2vecEmb.csv"), vocab, emb)

    demo_id = 158 if 158 in set(vocab.tolist()) else int(vocab[0])
    for mid, score in find_synonyms(vocab, emb, demo_id, 20, device=device):
        print(f"{mid} {score:.4f}")

    index = LSHIndex(emb, vocab)
    print("sampleEmb bucket ids:", index.buckets[0].tolist())
    print("approx NN of", demo_id, index.query(emb[vocab == demo_id][0], k=5))

    if args.graph_emb:
        gv, gemb = train_deepwalk(ratings, DeepWalkConfig(), device=device)
        write_embeddings_csv(os.path.join(out_dir, "itemGraphEmb.csv"), gv, gemb)
        print(f"deepwalk: {len(gv)} items")

    if args.user_emb:
        uids, uemb = generate_user_emb(ratings, vocab, emb)
        write_embeddings_csv(os.path.join(out_dir, "userEmb.csv"), uids, uemb)
        print(f"userEmb: {len(uids)} users")


if __name__ == "__main__":
    main()

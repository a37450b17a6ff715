"""The embedding plane against planted structure: `planted_item_latents`
and `neighbor_quality` of `tools/emb_scale.py` (:32-62) over the port's
top-k, and a run of the whole plane on synthetic ratings.

The synthetic generator's item latent factors can be rebuilt from its
seed, so "are the learned neighbourhoods real?" is the mean planted
cosine between each query item and its learned top-10 neighbours, beside
the mean planted cosine of random pairs.

    python -m sparrowrecsys_torch.tools.emb_quality [--events 1000000]
        [--epochs 2] [--batch-size 8192] [--walks 20000] [--json-out F] [--cpu]

runs sequences -> pairs -> SGNS -> CSR DeepWalk -> SGNS on
`synthetic_ratings` and prints each stage's seconds, the SGNS pairs/s
and both qualities. It runs on the CUDA device unless `--cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from sparrowrecsys_torch.ops.topk import cosine_topk
from sparrowrecsys_torch.utils.device import resolve_device


def planted_item_latents(spec) -> np.ndarray:
    """Replay synthetic_ratings' numpy stream as far as the item factors."""
    rng = np.random.default_rng(spec.seed)
    rng.normal(size=(spec.n_users, spec.latent_dim))  # user factors (discarded)
    return rng.normal(size=(spec.n_movies, spec.latent_dim)).astype(np.float32)


def neighbor_quality(vocab_ids: np.ndarray, emb: np.ndarray, vf: np.ndarray,
                     n_queries: int = 256, k: int = 10, seed: int = 0,
                     device=None) -> dict:
    """Mean planted cosine(query, neighbour) over the learned top-k
    neighbours, and the random-pair baseline; vocab_ids are 1-based ids."""
    rng = np.random.default_rng(seed)
    q = rng.choice(len(vocab_ids), size=min(n_queries, len(vocab_ids)), replace=False)
    table = torch.as_tensor(np.asarray(emb, np.float32)).to(resolve_device(device))
    _, idx = cosine_topk(table[torch.as_tensor(q, device=table.device)], table, k + 1)
    idx = idx.cpu().numpy()
    vfn = vf / np.maximum(np.linalg.norm(vf, axis=1, keepdims=True), 1e-9)
    lat = vfn[vocab_ids - 1]
    sims = []
    for row, qi in zip(idx, q):
        nbrs = [i for i in row if i != qi][:k]
        sims.append(float(np.mean(lat[nbrs] @ lat[qi])))
    rand = lat[rng.choice(len(lat), 4096)] * lat[rng.choice(len(lat), 4096)]
    return {
        "neighbor_planted_cos": round(float(np.mean(sims)), 4),
        "random_pair_cos": round(float(rand.sum(axis=1).mean()), 4),
    }


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(spec, epochs: int, batch_size: int, walks: int, device) -> dict:
    """The plane on `synthetic_ratings(spec)`: stage seconds, pairs/s, walks/s
    and the planted-structure quality of both embeddings."""
    from sparrowrecsys_torch.data.synthetic import synthetic_ratings
    from sparrowrecsys_torch.embedding.deepwalk import (
        DeepWalkConfig,
        random_walks_csr,
        transition_csr,
    )
    from sparrowrecsys_torch.embedding.item2vec import (
        Item2VecConfig,
        build_item_sequences,
        skipgram_pairs,
        train_sgns,
    )

    out = {"events": spec.n_events, "epochs": epochs, "batch_size": batch_size,
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    clock = time.perf_counter
    t0 = clock()
    ratings = synthetic_ratings(spec)
    out["gen_s"] = clock() - t0
    t0 = clock()
    seqs = build_item_sequences(ratings)
    out["seq_s"] = clock() - t0
    cfg = Item2VecConfig(epochs=epochs, batch_size=batch_size)
    vf = planted_item_latents(spec)

    t0 = clock()
    centers, contexts, vocab_ids, counts = skipgram_pairs(seqs, cfg.window)
    out.update(pairs_s=clock() - t0, n_pairs=int(len(centers)), vocab=int(len(vocab_ids)))
    t0 = clock()
    emb = train_sgns(centers, contexts, len(vocab_ids), counts, cfg, device=device)
    out["sgns_s"] = clock() - t0
    out["sgns_pairs_per_sec"] = epochs * len(centers) / out["sgns_s"]
    out["item2vec_quality"] = neighbor_quality(vocab_ids, emb, vf, device=device)

    t0 = clock()
    csr = transition_csr(seqs)
    out.update(csr_s=clock() - t0, n_edges=int(len(csr.dst)), walks=walks)
    dw = DeepWalkConfig(sample_count=walks, item2vec=cfg)
    _sync(device)
    t0 = clock()
    walked = random_walks_csr(csr, dw, device)
    out["walks_s"] = clock() - t0
    out["walks_per_sec"] = walks / out["walks_s"]
    t0 = clock()
    wc, wx, w_vocab, w_counts = skipgram_pairs(walked, cfg.window)
    w_emb = train_sgns(wc, wx, len(w_vocab), w_counts, cfg, device=device)
    out["walk_sgns_s"] = clock() - t0
    out["deepwalk_quality"] = neighbor_quality(w_vocab, w_emb, vf, device=device)
    return out


def main(argv=None) -> dict:
    from sparrowrecsys_torch.data.synthetic import SyntheticSpec

    ap = argparse.ArgumentParser()
    ap.add_argument("--events", type=int, default=1_000_000)
    ap.add_argument("--users", type=int, default=138_000)
    ap.add_argument("--movies", type=int, default=27_000)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=8192)
    ap.add_argument("--walks", type=int, default=20000)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU; the default is the CUDA device")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    out = run(SyntheticSpec(args.users, args.movies, args.events), args.epochs,
              args.batch_size, args.walks, device)
    for key in ("gen_s", "seq_s", "pairs_s", "sgns_s", "csr_s", "walks_s", "walk_sgns_s"):
        print(f"{key:12s} {out[key]:.3f}")
    print(f"SGNS {out['sgns_pairs_per_sec']:.0f} pairs/s over {out['n_pairs']} pairs, "
          f"vocab {out['vocab']}; {out['walks_per_sec']:.0f} walks/s over "
          f"{out['n_edges']} edges")
    print("item2vec quality:", out["item2vec_quality"])
    print("deepwalk quality:", out["deepwalk_quality"])
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()

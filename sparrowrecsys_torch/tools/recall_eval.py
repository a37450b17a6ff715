"""Retrieval quality, recall@K under one leave-one-out protocol: the port of
`tools/recall_eval.py`.

- Split: per user, the positives (rating >= 3.5) by timestamp; the last
  positive of each user with at least two is held out; every other event
  is training data.
- Score: rank the whole 1001-id catalog for the user, the user's training
  items excluded; a hit when the held-out item is in the top K. A test
  user a method cannot score counts as a miss.
- Methods: popularity (the floor), item2vec user embeddings, the two-tower
  trained as a retriever (in-batch softmax with logQ, serving adding
  `alpha * log p(item)` back), the two-tower trained as CTR through the
  port's `Trainer`, and popularity blended with item2vec kNN by a beta
  tuned on a validation split.

    python -m sparrowrecsys_torch.tools.recall_eval [--k 10] [--epochs 10]
        [--ctr-epochs 5] [--data-root DIR] [--json-out F] [--cpu]

The split, `recall_at_k` and popularity are numpy, copied from the JAX
tool, so popularity's recall equals the JAX tool's; the learned methods
train on the CUDA device unless `--cpu` is given.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from sparrowrecsys_torch.data.movielens import Ratings

N_ITEMS = 1001
POS_THRESHOLD = 3.5


def leave_one_out_split(ratings: Ratings):
    """(train Ratings, test pairs [(u, m)], seen {u: sorted train items})."""
    u, m = ratings.user_ids, ratings.movie_ids
    r, t = ratings.ratings, ratings.timestamps
    pos = r >= POS_THRESHOLD
    order = np.lexsort((t, u))
    test_mask = np.zeros(len(u), bool)
    su = u[order]
    starts = np.flatnonzero(np.concatenate([[True], su[1:] != su[:-1]]))
    ends = np.concatenate([starts[1:], [len(su)]])
    for s, e in zip(starts, ends):
        idx = order[s:e]
        p = idx[pos[idx]]
        if len(p) >= 2:
            test_mask[p[-1]] = True
    train = Ratings(u[~test_mask], m[~test_mask], r[~test_mask], t[~test_mask])
    test_pairs = list(zip(u[test_mask].tolist(), m[test_mask].tolist()))
    seen: dict = {}
    for uu, mm in zip(u[~test_mask], m[~test_mask]):
        seen.setdefault(int(uu), []).append(int(mm))
    seen = {k: np.unique(v) for k, v in seen.items()}
    return train, test_pairs, seen


def recall_at_k(score_rows, test_pairs, seen, k: int) -> float:
    """score_rows: {user_id: [N_ITEMS] scores}; seen train items are masked
    out before the top-k; a user without a row is a miss."""
    hits = total = 0
    for uu, mm in test_pairs:
        total += 1
        s = score_rows.get(int(uu))
        if s is None:
            continue
        s = s.copy()
        sn = seen.get(int(uu))
        if sn is not None:
            s[sn[sn < len(s)]] = -np.inf
        top = np.argpartition(-s, k)[:k]
        hits += int(mm in set(top.tolist()))
    return hits / max(total, 1)


def eval_popularity(train, test_pairs, seen, k, n_items=N_ITEMS) -> float:
    counts = np.bincount(train.movie_ids, minlength=n_items)[:n_items]
    s = counts.astype(np.float32)
    rows = {int(u): s for u, _ in test_pairs}
    return recall_at_k(rows, test_pairs, seen, k)


def eval_two_tower_retrieval(train, test_pairs, seen, k, epochs, seed=0, logq=True,
                             serve_pop_alpha=1.0, n_items=N_ITEMS, user_buckets=None,
                             device=None) -> float:
    """logQ-corrected in-batch-softmax towers (hidden (32, 32)); serving
    adds alpha * log p(item) back."""
    from sparrowrecsys_torch.models import build_model
    from sparrowrecsys_torch.training.retrieval import RetrievalConfig, RetrievalTrainer

    pos = train.ratings >= POS_THRESHOLD
    users = train.user_ids[pos]
    movies = train.movie_ids[pos]
    extra = {}
    if n_items != N_ITEMS:
        extra["movie_buckets"] = n_items
    if user_buckets is not None:
        extra["user_buckets"] = user_buckets
    model = build_model("neuralcf_two_tower", hidden=(32, 32), **extra)
    trainer = RetrievalTrainer(
        model, RetrievalConfig(batch_size=1024, epochs=epochs, seed=seed, logq=logq),
        device=device)
    params = trainer.fit_pairs(users, movies)
    item_vecs = trainer.item_matrix(params, n_items)
    uniq = np.unique([u for u, _ in test_pairs])
    uvecs = trainer.user_vectors(params, uniq)
    scores = (uvecs @ item_vecs.T).cpu().numpy()
    if serve_pop_alpha:
        counts = np.bincount(movies, minlength=n_items)[:n_items]
        scores = scores + serve_pop_alpha * np.log(np.maximum(counts, 0.5))
    return recall_at_k({int(u): scores[i] for i, u in enumerate(uniq)}, test_pairs, seen, k)


def _item2vec_item_vectors(train, n_items=N_ITEMS, device=None):
    """Row-normalized catalog-space item2vec vectors and the have-mask
    (the shipped Item2VecConfig)."""
    from sparrowrecsys_torch.embedding.item2vec import Item2VecConfig, train_item2vec

    vocab, emb = train_item2vec(train, Item2VecConfig(), device=device)
    full = np.zeros((n_items, emb.shape[1]), np.float32)
    have = np.zeros(n_items, bool)
    for i, v in enumerate(vocab):
        if 0 <= int(v) < n_items:
            full[int(v)] = emb[i]
            have[int(v)] = True
    fn = full / np.maximum(np.linalg.norm(full, axis=1, keepdims=True), 1e-9)
    return vocab, emb, fn, have


def eval_item2vec(train, test_pairs, seen, k, n_items=N_ITEMS, device=None) -> float:
    """Cosine of each catalog item to the user's item2vec user embedding;
    items without an embedding score -inf."""
    from sparrowrecsys_torch.embedding.user_emb import generate_user_emb

    vocab, emb, fn, have = _item2vec_item_vectors(train, n_items, device)
    uids, uemb = generate_user_emb(train, vocab, emb)
    urow = {int(x): i for i, x in enumerate(uids)}
    rows = {}
    for uu in {u for u, _ in test_pairs}:
        i = urow.get(int(uu))
        if i is None:
            continue
        q = uemb[i]
        q = q / max(np.linalg.norm(q), 1e-9)
        s = fn @ q
        s[~have] = -np.inf
        rows[int(uu)] = s
    return recall_at_k(rows, test_pairs, seen, k)


def eval_two_tower_ctr(train, test_pairs, seen, k, epochs, seed=0, device=None) -> float:
    """The two-tower trained pointwise on CTR labels (rating >= 3.5, the
    reference's NeuralCF recipe), ranking the catalog as a retriever."""
    from sparrowrecsys_torch.config import TrainConfig
    from sparrowrecsys_torch.data.dataset import EncodedDataset
    from sparrowrecsys_torch.models import build_model
    from sparrowrecsys_torch.training.loop import Trainer

    feats = {"movieId": train.movie_ids.astype(np.int32),
             "userId": train.user_ids.astype(np.int32)}
    labels = (train.ratings >= POS_THRESHOLD).astype(np.float32)
    trainer = Trainer(build_model("neuralcf_two_tower"),
                      TrainConfig(batch_size=2048, epochs=epochs, seed=seed), device=device)
    params = trainer.fit(EncodedDataset(feats, labels), verbose=False).params
    users = sorted({int(u) for u, _ in test_pairs})
    grid = EncodedDataset({
        "movieId": np.tile(np.arange(N_ITEMS, dtype=np.int32), len(users)),
        "userId": np.repeat(np.asarray(users, np.int32), N_ITEMS),
    }, np.zeros(len(users) * N_ITEMS, np.float32))
    probs = trainer.predict(params, grid, batch_size=65536).reshape(len(users), N_ITEMS)
    return recall_at_k(dict(zip(users, probs)), test_pairs, seen, k)


def _knn_personal_rows(train, users, fn, have):
    """Cosine of each catalog item to the mean of the user's train-positive
    item vectors; 0 where either side has no embedding."""
    pos = train.ratings >= POS_THRESHOLD
    hist: dict = {}
    for uu, mm in zip(train.user_ids[pos], train.movie_ids[pos]):
        if 0 <= int(mm) < N_ITEMS and have[int(mm)]:
            hist.setdefault(int(uu), []).append(int(mm))
    rows = {}
    for uu in users:
        h = hist.get(int(uu))
        if not h:
            rows[int(uu)] = np.zeros(N_ITEMS, np.float32)
            continue
        q = fn[h].mean(axis=0)
        q = q / max(np.linalg.norm(q), 1e-9)
        s = fn @ q
        s[~have] = 0.0
        rows[int(uu)] = s.astype(np.float32)
    return rows


def _zscore(x, mask=None):
    m = np.ones_like(x, bool) if mask is None else mask
    if not m.any():
        return np.zeros_like(x)
    mu, sd = x[m].mean(), x[m].std()
    return (x - mu) / max(sd, 1e-9)


def eval_tuned_blend(train, test_pairs, seen, k, device=None):
    """Popularity + beta * item2vec kNN, beta tuned on the same split
    applied to the train events; returns (test recall, beta)."""
    train2, val_pairs, seen2 = leave_one_out_split(train)
    betas = (0.0, 0.1, 0.25, 0.5, 1.0, 2.0, 4.0)

    def blend_recall(tr, pairs, sn, beta_list):
        counts = np.bincount(tr.movie_ids[tr.ratings >= POS_THRESHOLD],
                             minlength=N_ITEMS)[:N_ITEMS]
        pop = _zscore(np.log(np.maximum(counts, 0.5)).astype(np.float32))
        _, _, fn, have = _item2vec_item_vectors(tr, device=device)
        users = sorted({uu for uu, _ in pairs})
        personal = _knn_personal_rows(tr, users, fn, have)
        out = {}
        for beta in beta_list:
            rows = {uu: pop + beta * np.where(have, _zscore(personal[uu], have), 0.0)
                    for uu in users}
            out[beta] = recall_at_k(rows, pairs, sn, k)
        return out

    val = blend_recall(train2, val_pairs, seen2, betas)
    beta = max(betas, key=lambda b: val[b])
    print("  blend validation sweep:", {f"{b:g}": round(v, 4) for b, v in val.items()})
    test = blend_recall(train, test_pairs, seen, (beta,))
    return test[beta], beta


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--ctr-epochs", type=int, default=5)
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU; the default is the CUDA device")
    args = ap.parse_args(argv)

    import torch

    from sparrowrecsys_torch.config import DataConfig
    from sparrowrecsys_torch.data.movielens import load_ratings
    from sparrowrecsys_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    data = DataConfig() if args.data_root is None else DataConfig(data_root=args.data_root)
    train, test_pairs, seen = leave_one_out_split(load_ratings(data.path(data.ratings_csv)))
    print(f"leave-one-out: {len(test_pairs)} test users, {len(train)} train events")
    k = args.k
    pop = eval_popularity(train, test_pairs, seen, k)
    print(f"popularity           recall@{k} = {pop:.4f}")
    i2v = eval_item2vec(train, test_pairs, seen, k, device=device)
    print(f"item2vec             recall@{k} = {i2v:.4f}")
    rt = eval_two_tower_retrieval(train, test_pairs, seen, k, args.epochs, device=device)
    print(f"two_tower(retrieval) recall@{k} = {rt:.4f}")
    ctr = eval_two_tower_ctr(train, test_pairs, seen, k, args.ctr_epochs, device=device)
    print(f"two_tower(ctr)       recall@{k} = {ctr:.4f}")
    blend, beta = eval_tuned_blend(train, test_pairs, seen, k, device=device)
    print(f"tuned_blend(b={beta:g})  recall@{k} = {blend:.4f}")
    out = {
        "k": k,
        "protocol": "leave-one-out, seen-items excluded",
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "n_test": len(test_pairs),
        "popularity": pop,
        "item2vec": i2v,
        "two_tower_retrieval": rt,
        "two_tower_ctr": ctr,
        "tuned_blend": blend,
        "tuned_blend_beta": beta,
    }
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f)
    return out


if __name__ == "__main__":
    main()

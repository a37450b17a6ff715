"""Item2vec, skip-gram with negative sampling: the port of
`sparrowrecsys_tpu/embedding/item2vec.py`.

Per-user watch sequences (rating >= 3.5, by timestamp) become (center,
context) pairs over a dense vocabulary on the host (numpy, copied from the
JAX package so both give the same pairs); training is one SGNS step per
batch on the device: three row gathers, a [B, 1+N] dot, the explicit
gradients of -log σ(pos) - Σ log σ(-neg), and the rows summed back into
both tables by `index_add_` (atomic on CUDA, so two card runs may differ
in the last bits). Negatives come from unigram^0.75 through Walker alias
tables: one `randint` and one uniform per negative, no rejection of the
positive.

The JAX package sums the table updates as one-hot products at
V <= 2048 and cuts an epoch into scan chunks of at most 256 steps; both
are TPU devices with the same math, and the port has neither.

Draws come from a `torch.Generator` on the device seeded with
`Item2VecConfig.seed`. `train_sgns` also takes them injected (`init`,
`orders`, `negatives`), so a run can replay another package's or
another device's schedule.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparrowrecsys_torch.config import POSITIVE_RATING_THRESHOLD
from sparrowrecsys_torch.data.movielens import Ratings
from sparrowrecsys_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Item2VecConfig:
    dim: int = 10                # embLength (Embedding.scala:314)
    window: int = 5              # windowSize (Embedding.scala:132)
    epochs: int = 10             # numIterations (Embedding.scala:133)
    negatives: int = 5
    batch_size: int = 8192
    learning_rate: float = 0.025
    min_count: int = 1
    seed: int = 2024


def build_item_sequences(
    ratings: Ratings, threshold: float = POSITIVE_RATING_THRESHOLD
) -> List[np.ndarray]:
    """Per-user watch sequences of movieIds: rating >= threshold, sorted by
    timestamp (ties keep input order); users with one such event dropped."""
    keep = ratings.ratings >= threshold
    u = ratings.user_ids[keep]
    m = ratings.movie_ids[keep]
    t = ratings.timestamps[keep]
    order = np.lexsort((np.arange(len(u)), t, u))
    u, m = u[order], m[order]
    seqs: List[np.ndarray] = []
    if len(u) == 0:
        return seqs
    bounds = np.flatnonzero(np.diff(u)) + 1
    for chunk in np.split(m, bounds):
        if len(chunk) >= 2:
            seqs.append(chunk.astype(np.int64))
    return seqs


def skipgram_pairs(
    sequences: Sequence[np.ndarray], window: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(centers, contexts, vocab_ids, counts): centers/contexts index
    vocab_ids (the sorted unique movieIds); counts are the vocabulary's
    occurrence counts, the negative sampler's base distribution."""
    flat = np.concatenate(sequences) if sequences else np.empty(0, np.int64)
    vocab_ids, inv = np.unique(flat, return_inverse=True)
    counts = np.bincount(inv, minlength=len(vocab_ids)).astype(np.float64)
    # Positions at least d before their sequence's end pair with the
    # position d ahead, over all sequences at once.
    n_total = len(flat)
    lens = np.array([len(s) for s in sequences], np.int64)
    ends = np.repeat(np.cumsum(lens), lens)
    pos = np.arange(n_total)
    centers_parts, contexts_parts = [], []
    for d in range(1, window + 1):
        ok = pos + d < ends
        a, b = inv[pos[ok]], inv[pos[ok] + d]
        centers_parts.append(a); contexts_parts.append(b)  # center -> right
        centers_parts.append(b); contexts_parts.append(a)  # center -> left
    if centers_parts:
        c = np.concatenate(centers_parts); x = np.concatenate(contexts_parts)
    else:
        c = np.empty(0, np.int64); x = np.empty(0, np.int64)
    return c.astype(np.int32), x.astype(np.int32), vocab_ids, counts


def build_alias_table(p: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Walker alias tables (prob [V] float32, alias [V] int32) of a
    categorical distribution: an O(V) host build, two gathers a draw."""
    p = np.asarray(p, np.float64)
    v = len(p)
    scaled = p / p.sum() * v
    prob = np.ones(v, np.float64)
    alias = np.arange(v, dtype=np.int64)
    small = [i for i in range(v) if scaled[i] < 1.0]
    large = [i for i in range(v) if scaled[i] >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = scaled[l] - (1.0 - scaled[s])
        (small if scaled[l] < 1.0 else large).append(l)
    return prob.astype(np.float32), alias.astype(np.int32)


def pack_alias(prob: np.ndarray, alias: np.ndarray, device=None) -> torch.Tensor:
    """[V, 2] float32 (prob, alias), so a draw is one row gather; the alias
    id rides as float32, exact for V < 2^24."""
    packed = np.stack([prob, alias.astype(np.float32)], axis=1)
    return torch.from_numpy(packed).to(resolve_device(device))


def alias_draw(packed: torch.Tensor, shape, generator: torch.Generator) -> torch.Tensor:
    """int64 ids of `shape` from the packed alias table: a uniform cell,
    kept with its prob, else its alias."""
    dev = packed.device
    idx = torch.randint(0, packed.shape[0], shape, generator=generator, device=dev)
    pa = packed[idx]
    keep = torch.rand(shape, generator=generator, device=dev) < pa[..., 0]
    return torch.where(keep, idx, pa[..., 1].long())


def sgns_step(emb_in: torch.Tensor, emb_out: torch.Tensor, centers: torch.Tensor,
              contexts: torch.Tensor, neg_idx: torch.Tensor, lr: float) -> torch.Tensor:
    """One SGNS step on [B] centers, [B] contexts and [B, N] negatives,
    updating both tables in place (every gather reads the tables before
    the step); returns the batch's mean loss."""
    u = emb_in[centers]                                   # [B, D]
    v_pos = emb_out[contexts]                             # [B, D]
    v_neg = emb_out[neg_idx]                              # [B, N, D]
    pos_logit = (u * v_pos).sum(-1)                       # [B]
    neg_logit = (u[:, None, :] * v_neg).sum(-1)           # [B, N]
    g_pos = torch.sigmoid(pos_logit) - 1.0
    g_neg = torch.sigmoid(neg_logit)
    du = g_pos[:, None] * v_pos + (g_neg[..., None] * v_neg).sum(1)
    dv_pos = g_pos[:, None] * u
    dv_neg = g_neg[..., None] * u[:, None, :]
    emb_in.index_add_(0, centers, du, alpha=-lr)
    emb_out.index_add_(0, torch.cat([contexts, neg_idx.reshape(-1)]),
                       torch.cat([dv_pos, dv_neg.reshape(-1, u.shape[-1])]), alpha=-lr)
    return -(torch.nn.functional.logsigmoid(pos_logit)
             + torch.nn.functional.logsigmoid(-neg_logit).sum(-1)).mean()


def sgns_shape(n_pairs: int, batch_size: int) -> Tuple[int, int]:
    """(batch, steps per epoch): the tail past steps * batch pairs is dropped."""
    bs = min(batch_size, max(n_pairs, 1))
    return bs, max(n_pairs // bs, 1)


def sgns_lr(config: Item2VecConfig, step: int, total_steps: int) -> float:
    """lr0 * max(1 - t/total, 1e-4) at global step t, in float32 as the JAX
    scan computes it."""
    f = np.float32
    return float(f(config.learning_rate)
                 * np.maximum(f(1.0) - f(step) / f(total_steps), f(1e-4)))


def epoch_order(n_pairs: int, batch_size: int, generator: torch.Generator) -> torch.Tensor:
    """An epoch's pair order: a permutation cut to steps * batch (int64)."""
    bs, steps = sgns_shape(n_pairs, batch_size)
    perm = torch.randperm(n_pairs, generator=generator, device=generator.device)
    return perm[: steps * bs]


def _tensor(x, device, dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def train_sgns(
    centers: np.ndarray,
    contexts: np.ndarray,
    vocab_size: int,
    counts: np.ndarray,
    config: Item2VecConfig,
    verbose: bool = False,
    device=None,
    init: Optional[np.ndarray] = None,
    orders: Optional[Sequence] = None,
    negatives: Optional[Sequence] = None,
) -> np.ndarray:
    """SGNS over pre-extracted pairs; returns the input table [V, D] (numpy).

    The input table starts uniform in ±0.5/dim and the output table at
    zero; the learning rate decays linearly to 1e-4x over epochs x steps.
    Injected draws, each optional: `init` the initial input table [V, D];
    `orders[e]` epoch e's pair order ([steps * batch] indices);
    `negatives[e]` epoch e's negatives ([steps, batch, negatives] ids).
    What is not injected is drawn from a generator on the device seeded
    with `config.seed`: the table, then per epoch the order and per step
    the negatives."""
    dev = resolve_device(device)
    v = vocab_size
    if v == 0 or len(centers) == 0:
        return np.zeros((v, config.dim), np.float32)
    packed = pack_alias(*build_alias_table(counts ** 0.75), device=dev)
    gen = torch.Generator(device=dev).manual_seed(config.seed)
    if init is None:
        emb_in = (torch.rand((v, config.dim), generator=gen, device=dev)
                  * (1.0 / config.dim) - 0.5 / config.dim)
    else:
        emb_in = _tensor(init, dev, torch.float32)
        if emb_in.shape != (v, config.dim):
            raise ValueError(f"init has shape {tuple(emb_in.shape)}, want {(v, config.dim)}")
    emb_out = torch.zeros((v, config.dim), dtype=torch.float32, device=dev)

    n = len(centers)
    bs, steps = sgns_shape(n, config.batch_size)
    total = config.epochs * steps
    centers_d = _tensor(centers, dev, torch.int64)
    contexts_d = _tensor(contexts, dev, torch.int64)
    for epoch in range(config.epochs):
        t0 = time.perf_counter()
        if orders is None:
            order = epoch_order(n, config.batch_size, gen)
        else:
            order = _tensor(orders[epoch], dev, torch.int64)
            if order.shape != (steps * bs,):
                raise ValueError(f"orders[{epoch}] has shape {tuple(order.shape)}, "
                                 f"want ({steps * bs},)")
        c_all = centers_d[order].view(steps, bs)
        x_all = contexts_d[order].view(steps, bs)
        negs = None if negatives is None else _tensor(negatives[epoch], dev, torch.int64)
        if negs is not None and negs.shape != (steps, bs, config.negatives):
            raise ValueError(f"negatives[{epoch}] has shape {tuple(negs.shape)}, "
                             f"want {(steps, bs, config.negatives)}")
        for s in range(steps):
            neg = (alias_draw(packed, (bs, config.negatives), gen) if negs is None
                   else negs[s])
            sgns_step(emb_in, emb_out, c_all[s], x_all[s], neg,
                      sgns_lr(config, epoch * steps + s, total))
        if verbose:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            print(f"  sgns epoch {epoch + 1}/{config.epochs}: {dt:.3f}s "
                  f"({steps * bs / dt / 1e6:.2f}M pairs/s)", flush=True)
    return emb_in.cpu().numpy()


def train_item2vec(
    ratings: Ratings, config: Item2VecConfig = Item2VecConfig(), device=None
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (vocab_ids [V], embeddings [V, D]): the item2vecEmb table."""
    seqs = build_item_sequences(ratings)
    centers, contexts, vocab_ids, counts = skipgram_pairs(seqs, config.window)
    emb = train_sgns(centers, contexts, len(vocab_ids), counts, config, device=device)
    return vocab_ids, emb


def find_synonyms(
    vocab_ids: np.ndarray, emb: np.ndarray, movie_id: int, k: int = 20, device=None
) -> List[Tuple[int, float]]:
    """Cosine top-k neighbours, the movie itself left out: the
    `findSynonyms("158", 20)` demo (Embedding.scala:139-142)."""
    from sparrowrecsys_torch.ops.topk import cosine_topk

    pos = np.flatnonzero(vocab_ids == movie_id)
    if len(pos) == 0:
        return []
    table = _tensor(emb, resolve_device(device), torch.float32)
    scores, idx = cosine_topk(table[pos], table, min(k + 1, len(emb)))
    out = []
    for i, s in zip(idx[0].cpu().numpy(), scores[0].cpu().numpy()):
        if vocab_ids[i] != movie_id and len(out) < k:
            out.append((int(vocab_ids[i]), float(s)))
    return out

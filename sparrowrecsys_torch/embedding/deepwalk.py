"""DeepWalk: random walks on the item graph on the device, then skip-gram:
the port of `sparrowrecsys_tpu/embedding/deepwalk.py`.

Adjacent-pair counts give a row-normalized transition graph and the
walk-start distribution (the out-edge frequency, `generateTransitionMatrix`,
Embedding.scala:225-271); 20,000 walks of length 10 advance all walkers
one edge per step; the walks become SGNS pairs (`graphEmb`, :299-311).

Two walkers, both fed a start per walker and one uniform per walker and
step ([L-1, W]):
- dense (V <= DENSE_WALK_MAX_VOCAB): the next item is the first column
  whose row CDF exceeds the uniform, over a [V, V] CDF;
- CSR: a bisection over the walker's row of `cum` for a fixed
  ceil(log2(max degree)) + 1 iterations; a uniform past the row's last
  float32 `cum` lands on the row's last edge.
A walker at a row with no out-edges stops, and its later positions are
dropped: a walk's length is 1 plus its live steps (Embedding.scala:186-200).
The starts and uniforms come from a generator on the device seeded with
`DeepWalkConfig.seed`; the builders of the graph are numpy, copied from
the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from sparrowrecsys_torch.data.movielens import Ratings
from sparrowrecsys_torch.embedding.item2vec import (
    Item2VecConfig,
    build_item_sequences,
    skipgram_pairs,
    train_sgns,
)
from sparrowrecsys_torch.utils.device import resolve_device

#: Above this many distinct items the dense [V, V] graph and its [W, V]
#: per-step row gather are too large; `random_walks` takes the CSR walker.
DENSE_WALK_MAX_VOCAB = 4096


@dataclasses.dataclass(frozen=True)
class DeepWalkConfig:
    sample_count: int = 20000    # Embedding.scala:305
    sample_length: int = 10      # Embedding.scala:306
    seed: int = 2024
    item2vec: Item2VecConfig = Item2VecConfig()


def adjacent_pairs(
    sequences: Sequence[np.ndarray],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(vocab_ids [V], src [P], dst [P]): every adjacent (item, next item)
    pair of all sequences as dense vocab indices."""
    if not sequences:
        e = np.empty(0, np.int64)
        return e, e.astype(np.int32), e.astype(np.int32)
    flat = np.concatenate(sequences)
    vocab_ids, inv = np.unique(flat, return_inverse=True)
    lens = np.array([len(s) for s in sequences], np.int64)
    ends = np.repeat(np.cumsum(lens), lens)
    pos = np.arange(len(flat))
    ok = pos + 1 < ends
    return vocab_ids, inv[pos[ok]].astype(np.int32), inv[pos[ok] + 1].astype(np.int32)


def transition_matrix(
    sequences: Sequence[np.ndarray],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(vocab_ids [V], transition [V, V] row-stochastic, item_dist [V]);
    rows with no out-edges carry a self-loop."""
    vocab_ids, src, dst = adjacent_pairs(sequences)
    v = len(vocab_ids)
    if v == 0:
        return vocab_ids, np.zeros((0, 0)), np.zeros(0)
    trans = np.zeros((v, v), np.float64)
    np.add.at(trans, (src, dst), 1.0)
    out_count = trans.sum(axis=1)
    total = out_count.sum()
    item_dist = out_count / max(total, 1.0)
    dead = out_count == 0
    trans[dead, np.flatnonzero(dead)] = 1.0  # self-loop on dead ends
    trans = trans / trans.sum(axis=1, keepdims=True)
    return vocab_ids, trans.astype(np.float32), item_dist.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class TransitionCSR:
    """Row-compressed weighted item graph: rowptr [V+1]; dst [E] neighbour
    indices; cum [E] within-row cumulative probabilities; item_dist [V]
    the walk-start distribution."""

    vocab_ids: np.ndarray
    rowptr: np.ndarray
    dst: np.ndarray
    cum: np.ndarray
    item_dist: np.ndarray


def transition_csr(sequences: Sequence[np.ndarray]) -> TransitionCSR:
    """`transition_matrix` in O(E) memory, without the dead-end self-loops."""
    vocab_ids, src, dst = adjacent_pairs(sequences)
    v = len(vocab_ids)
    if v == 0:
        z = np.zeros(0)
        return TransitionCSR(vocab_ids, np.zeros(1, np.int32), z.astype(np.int32), z, z)
    key = src.astype(np.int64) * v + dst.astype(np.int64)
    uniq, counts = np.unique(key, return_counts=True)
    e_src = (uniq // v).astype(np.int32)
    e_dst = (uniq % v).astype(np.int32)
    w = counts.astype(np.float64)
    out_count = np.bincount(e_src, weights=w, minlength=v)
    rowptr = np.zeros(v + 1, np.int64)
    np.cumsum(np.bincount(e_src, minlength=v), out=rowptr[1:])
    cum = np.cumsum(w)
    row_base = np.concatenate([[0.0], cum])[rowptr[:-1]]
    row_tot = np.maximum(out_count, 1e-30)
    cum_in_row = (cum - np.repeat(row_base, np.diff(rowptr))) / np.repeat(
        row_tot, np.diff(rowptr)
    )
    item_dist = out_count / max(out_count.sum(), 1.0)
    return TransitionCSR(
        vocab_ids, rowptr.astype(np.int32), e_dst,
        cum_in_row.astype(np.float32), item_dist.astype(np.float32),
    )


def walk_draws(item_dist: np.ndarray, n_walks: int, length: int,
               generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """(start [W] int64 drawn from item_dist, uniforms [L-1, W] float32)
    on the generator's device."""
    dev = generator.device
    p = torch.as_tensor(np.asarray(item_dist, np.float64)).to(dev)
    start = torch.multinomial(p, n_walks, replacement=True, generator=generator)
    return start, torch.rand((length - 1, n_walks), generator=generator, device=dev)


def bisect_iters(rowptr: np.ndarray) -> int:
    max_deg = int(np.diff(rowptr).max()) if len(rowptr) > 1 else 1
    return max(int(np.ceil(np.log2(max(max_deg, 2)))) + 1, 1)


def walk_csr(rowptr: torch.Tensor, dst: torch.Tensor, cum: torch.Tensor,
             start: torch.Tensor, uniforms: torch.Tensor, iters: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(walks [W, L] int64, valid [W, L] bool) over the CSR graph."""
    last = max(dst.shape[0] - 1, 0)
    cur = start.long()
    alive = torch.ones_like(cur, dtype=torch.bool)
    walks, valid = [cur], [alive]
    for u in uniforms:
        lo, hi = rowptr[cur].long(), rowptr[cur + 1].long()
        alive = alive & (hi > lo)
        # invariant: the answer is in [l, h]; it is the first cum >= u
        l, h = lo, torch.maximum(hi - 1, lo)
        for _ in range(iters):
            mid = (l + h) // 2
            go_right = cum[mid.clamp_max(last)] < u
            l = torch.where(go_right, torch.minimum(mid + 1, h), l)
            h = torch.where(go_right, h, mid)
        cur = torch.where(alive, dst[l.clamp_max(last)].long(), cur)
        walks.append(cur)
        valid.append(alive)
    return torch.stack(walks, 1), torch.stack(valid, 1)


def dense_cdf(trans: np.ndarray) -> np.ndarray:
    """[V, V] float32 row CDFs of a transition matrix, 1.0 from each row's
    last edge on, so the first column over any uniform in [0, 1) is an edge."""
    cdf = np.cumsum(np.asarray(trans, np.float64), axis=1)
    nz = np.asarray(trans) > 0
    last_edge = trans.shape[1] - 1 - np.argmax(nz[:, ::-1], axis=1)
    cdf[np.arange(trans.shape[1])[None, :] >= last_edge[:, None]] = 1.0
    return cdf.astype(np.float32)


def walk_dense(cdf: torch.Tensor, dead: torch.Tensor, start: torch.Tensor,
               uniforms: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(walks [W, L] int64, valid [W, L] bool) by inverse CDF over [V, V]."""
    cur = start.long()
    alive = torch.ones_like(cur, dtype=torch.bool)
    walks, valid = [cur], [alive]
    for u in uniforms:
        nxt = torch.searchsorted(cdf[cur], u[:, None].contiguous(), right=True)[:, 0]
        alive = alive & ~dead[cur]
        cur = torch.where(alive, nxt, cur)
        walks.append(cur)
        valid.append(alive)
    return torch.stack(walks, 1), torch.stack(valid, 1)


def _truncate(vocab_ids, walks: torch.Tensor, valid: torch.Tensor) -> List[np.ndarray]:
    walks = walks.cpu().numpy()
    lengths = valid.sum(1).cpu().numpy()
    return [vocab_ids[w[:n]] for w, n in zip(walks, lengths)]


def random_walks_csr(
    csr: TransitionCSR, config: DeepWalkConfig = DeepWalkConfig(), device=None
) -> List[np.ndarray]:
    """Walks as movieId arrays over the CSR graph, truncated at dead ends."""
    if len(csr.vocab_ids) == 0:
        return []
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(config.seed)
    start, uniforms = walk_draws(csr.item_dist, config.sample_count,
                                 config.sample_length, gen)
    graph = [torch.from_numpy(a).to(dev) for a in (csr.rowptr, csr.dst, csr.cum)]
    walks, valid = walk_csr(*graph, start, uniforms, bisect_iters(csr.rowptr))
    return _truncate(csr.vocab_ids, walks, valid)


def random_walks(
    sequences: Sequence[np.ndarray], config: DeepWalkConfig = DeepWalkConfig(), device=None
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(vocab_ids, walks as movieId arrays truncated at dead ends); the CSR
    walker above DENSE_WALK_MAX_VOCAB items."""
    n_items = len(np.unique(np.concatenate(sequences))) if sequences else 0
    if n_items > DENSE_WALK_MAX_VOCAB:
        csr = transition_csr(sequences)
        return csr.vocab_ids, random_walks_csr(csr, config, device)
    vocab_ids, trans, dist = transition_matrix(sequences)
    if len(vocab_ids) == 0:
        return vocab_ids, []
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(config.seed)
    start, uniforms = walk_draws(dist, config.sample_count, config.sample_length, gen)
    walks, valid = walk_dense(torch.from_numpy(dense_cdf(trans)).to(dev),
                              torch.from_numpy(dist == 0).to(dev), start, uniforms)
    return vocab_ids, _truncate(vocab_ids, walks, valid)


def train_deepwalk(
    ratings: Ratings, config: DeepWalkConfig = DeepWalkConfig(), device=None
) -> Tuple[np.ndarray, np.ndarray]:
    """sequences -> walks -> skip-gram. Returns (vocab_ids, embeddings); the
    vocabulary is the walks', so an item no walk visits is absent."""
    seqs = build_item_sequences(ratings)
    _, walks = random_walks(seqs, config, device)
    cfg = config.item2vec
    centers, contexts, vocab_ids, counts = skipgram_pairs(walks, cfg.window)
    emb = train_sgns(centers, contexts, len(vocab_ids), counts, cfg, device=device)
    return vocab_ids, emb

"""ALS collaborative filtering: the port of `sparrowrecsys_tpu/models/als.py`
(`CollaborativeFiltering.scala`: `ALS(maxIter=5, regParam=0.01, rank=10,
coldStartStrategy="drop")` on an 80/20 split, RMSE, `recommendForAll*`,
a 10-fold `CrossValidator`).

Each half-iteration solves every user's (then every item's) k x k normal
equations in one batched `torch.linalg.solve`: the Gram matrices and
right-hand sides are summed over the rating triples by `index_add_`
(atomic on CUDA, so two card runs may differ in the last bits), with
ALS-WR regularisation `reg * max(count, 1)`, so an empty row solves to
zero. Above ALS_CHUNK_EVENTS ratings the sums run chunk by chunk to bound
the [N, k*k] outer products. Recommendations rank through the top-k in
`lax.top_k`'s order (`ops/topk.py::top_k`).

    python -m sparrowrecsys_torch.models.als [--cv] [--data-root DIR] [--cpu]
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sparrowrecsys_torch.data.movielens import Ratings
from sparrowrecsys_torch.ops.topk import top_k
from sparrowrecsys_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ALSConfig:
    rank: int = 10          # Spark ALS default
    max_iter: int = 5       # CollaborativeFiltering.scala:53
    reg_param: float = 0.01 # scala:54
    seed: int = 2024


@dataclasses.dataclass
class ALSModel:
    user_ids: np.ndarray     # [U] external ids
    item_ids: np.ndarray     # [I]
    user_factors: np.ndarray # [U, k]
    item_factors: np.ndarray # [I, k]

    def _rows(self, ids: np.ndarray, ext: np.ndarray) -> np.ndarray:
        if len(ids) == 0:
            return np.full(len(ext), -1, np.int64)
        idx = np.searchsorted(ids, ext)
        idx = np.minimum(idx, len(ids) - 1)
        return np.where(ids[idx] == ext, idx, -1).astype(np.int64)

    def predict(self, user_ids: np.ndarray, item_ids: np.ndarray) -> np.ndarray:
        """Dot-product predictions; NaN for unseen users or items."""
        u = self._rows(self.user_ids, user_ids)
        i = self._rows(self.item_ids, item_ids)
        ok = (u >= 0) & (i >= 0)
        out = np.full(len(u), np.nan, np.float32)
        if ok.any():
            out[ok] = np.einsum(
                "nd,nd->n", self.user_factors[u[ok]], self.item_factors[i[ok]]
            )
        return out

    def transform_drop(self, ratings: Ratings) -> Tuple[np.ndarray, np.ndarray]:
        """(predictions, actuals) with cold-start rows dropped
        (`setColdStartStrategy("drop")`, scala:63)."""
        pred = self.predict(ratings.user_ids, ratings.movie_ids)
        keep = ~np.isnan(pred)
        return pred[keep], ratings.ratings[keep]

    def rmse(self, ratings: Ratings) -> float:
        pred, actual = self.transform_drop(ratings)
        if len(pred) == 0:
            return float("nan")
        return float(np.sqrt(np.mean((pred - actual) ** 2)))

    @staticmethod
    def _recommend(rows, cols, row_ids, col_ids, k, device) -> Dict[int, list]:
        dev = resolve_device(device)
        scores = torch.from_numpy(rows).to(dev) @ torch.from_numpy(cols).to(dev).T
        s, idx = top_k(scores, min(k, len(col_ids)))
        s, idx = s.cpu().numpy(), idx.cpu().numpy()
        return {
            int(r): [(int(col_ids[j]), float(v)) for j, v in zip(row, sv)]
            for r, row, sv in zip(row_ids, idx, s)
        }

    def recommend_for_all_users(self, k: int = 10, device=None) -> Dict[int, list]:
        """Top-k items per user over all items (no watched filter, as Spark)."""
        return self._recommend(self.user_factors, self.item_factors, self.user_ids,
                               self.item_ids, k, device)

    def recommend_for_all_items(self, k: int = 10, device=None) -> Dict[int, list]:
        return self._recommend(self.item_factors, self.user_factors, self.item_ids,
                               self.user_ids, k, device)

    def recommend_for_user_subset(self, users, k: int = 10, device=None) -> Dict[int, list]:
        all_recs = self.recommend_for_all_users(k, device)
        return {int(u): all_recs[int(u)] for u in users if int(u) in all_recs}


#: Above this many ratings the normal equations are summed chunk by chunk
#: (`_solve_side_chunked`), bounding the [chunk, k*k] outer products.
ALS_CHUNK_EVENTS = 4_000_000


def _outer2d(f: torch.Tensor) -> torch.Tensor:
    """Row-wise outer products [N, k*k]."""
    return (f[:, :, None] * f[:, None, :]).reshape(f.shape[0], -1)


def _accumulate(fixed, row_idx, col_idx, values, n_rows, sums=None):
    """Adds one chunk's (gram [R, k*k], rhs [R, k], counts [R]) to `sums`."""
    k = fixed.shape[1]
    if sums is None:
        sums = (fixed.new_zeros((n_rows, k * k)), fixed.new_zeros((n_rows, k)),
                fixed.new_zeros((n_rows,)))
    gram, rhs, counts = sums
    f = fixed[col_idx]
    gram.index_add_(0, row_idx, _outer2d(f))
    rhs.index_add_(0, row_idx, values[:, None] * f)
    counts.index_add_(0, row_idx, torch.ones_like(values))
    return sums


def _solve_rows(gram, rhs, counts, reg: float) -> torch.Tensor:
    """A_r = gram_r + reg * max(n_r, 1) * I; solves A_r x = rhs_r for all r."""
    k = rhs.shape[1]
    eye = torch.eye(k, dtype=rhs.dtype, device=rhs.device)
    a = gram.view(-1, k, k) + (reg * counts.clamp_min(1.0))[:, None, None] * eye
    return torch.linalg.solve(a, rhs[:, :, None])[:, :, 0]


def _solve_side(fixed, row_idx, col_idx, values, reg: float, n_rows: int) -> torch.Tensor:
    """All target rows' normal equations, summed over all ratings at once."""
    return _solve_rows(*_accumulate(fixed, row_idx, col_idx, values, n_rows), reg)


def _solve_side_chunked(fixed, row_idx, col_idx, values, reg: float, n_rows: int,
                        chunk: int) -> torch.Tensor:
    """`_solve_side` with the sums taken `chunk` ratings at a time (the
    same result up to the float32 order of the sums)."""
    sums = None
    for lo in range(0, len(values), chunk):
        sl = slice(lo, lo + chunk)
        sums = _accumulate(fixed, row_idx[sl], col_idx[sl], values[sl], n_rows, sums)
    return _solve_rows(*sums, reg)


def train_als(ratings: Ratings, config: ALSConfig = ALSConfig(), device=None,
              init: Optional[Tuple[np.ndarray, np.ndarray]] = None) -> ALSModel:
    """User side first, then item side, `max_iter` times. `init`: the
    initial (user [U, k], item [I, k]) factors; by default uniform(0, 1) /
    sqrt(k) from a generator on the device seeded with `config.seed`."""
    dev = resolve_device(device)
    user_ids, u_idx = np.unique(ratings.user_ids, return_inverse=True)
    item_ids, i_idx = np.unique(ratings.movie_ids, return_inverse=True)
    n_u, n_i = len(user_ids), len(item_ids)
    k = config.rank
    if init is None:
        gen = torch.Generator(device=dev).manual_seed(config.seed)
        uf = torch.rand((n_u, k), generator=gen, device=dev) / np.sqrt(k)
        vf = torch.rand((n_i, k), generator=gen, device=dev) / np.sqrt(k)
    else:
        uf, vf = (torch.tensor(np.asarray(a, np.float32), device=dev) for a in init)
        if uf.shape != (n_u, k) or vf.shape != (n_i, k):
            raise ValueError(f"init factors {tuple(uf.shape)}, {tuple(vf.shape)}; "
                             f"want {(n_u, k)}, {(n_i, k)}")
    u_t = torch.from_numpy(u_idx.astype(np.int64)).to(dev)
    i_t = torch.from_numpy(i_idx.astype(np.int64)).to(dev)
    vals = torch.from_numpy(np.asarray(ratings.ratings, np.float32)).to(dev)
    reg = config.reg_param
    chunk = ALS_CHUNK_EVENTS
    for _ in range(config.max_iter):
        if len(vals) > chunk:
            uf = _solve_side_chunked(vf, u_t, i_t, vals, reg, n_u, chunk)
            vf = _solve_side_chunked(uf, i_t, u_t, vals, reg, n_i, chunk)
        else:
            uf = _solve_side(vf, u_t, i_t, vals, reg, n_u)
            vf = _solve_side(uf, i_t, u_t, vals, reg, n_i)
    return ALSModel(user_ids, item_ids, uf.cpu().numpy(), vf.cpu().numpy())


def _subset(ratings: Ratings, sel) -> Ratings:
    return Ratings(ratings.user_ids[sel], ratings.movie_ids[sel],
                   ratings.ratings[sel], ratings.timestamps[sel])


def cross_validate(
    ratings: Ratings,
    config: ALSConfig = ALSConfig(),
    reg_grid=(0.01,),
    num_folds: int = 10,
    seed: int = 2024,
    device=None,
) -> Dict[float, float]:
    """`CrossValidator(numFolds=10)` over a regParam grid (scala:98-112):
    mean held-out RMSE per grid point; the folds are numpy's, as the JAX
    package draws them."""
    rng = np.random.default_rng(seed)
    fold = rng.integers(0, num_folds, len(ratings))
    out: Dict[float, float] = {}
    for reg in reg_grid:
        cfg = dataclasses.replace(config, reg_param=reg)
        scores = []
        for f in range(num_folds):
            model = train_als(_subset(ratings, fold != f), cfg, device)
            scores.append(model.rmse(_subset(ratings, fold == f)))
        out[reg] = float(np.nanmean(scores))
    return out


def split_80_20(ratings: Ratings, seed: int = 2024) -> Tuple[Ratings, Ratings]:
    """`main`'s random 80/20 split (scala:45-47), numpy's draw as the JAX package's."""
    mask = np.random.default_rng(seed).random(len(ratings)) < 0.8
    return _subset(ratings, mask), _subset(ratings, ~mask)


def main(argv=None) -> None:
    """`CollaborativeFiltering.main`: 80/20 split, train, RMSE, a factor
    peek, all-users and all-items top-10, subset recs, `--cv` 10-fold CV."""
    import argparse

    from sparrowrecsys_torch.config import DataConfig
    from sparrowrecsys_torch.data.movielens import load_ratings

    ap = argparse.ArgumentParser()
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--cv", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU; the default is the CUDA device")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    data = DataConfig() if args.data_root is None else DataConfig(data_root=args.data_root)
    tr, te = split_80_20(load_ratings(data.path(data.ratings_csv)))
    model = train_als(tr, device=device)
    print("itemFactors (first 3):")
    for i in range(min(3, len(model.item_ids))):
        print(" ", int(model.item_ids[i]), np.round(model.item_factors[i], 3))
    print(f"Root-mean-square error = {model.rmse(te)}")
    user_recs = model.recommend_for_all_users(10, device)
    item_recs = model.recommend_for_all_items(10, device)
    some_users = list(user_recs)[:3]
    print("userSubsetRecs:", {u: user_recs[u][:3] for u in some_users})
    print(f"({len(user_recs)} users, {len(item_recs)} items with recs)")
    if args.cv:
        print(f"Cross-validated metrics: {cross_validate(te, num_folds=10, device=device)}")


if __name__ == "__main__":
    main()

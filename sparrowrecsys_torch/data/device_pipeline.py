"""The feature job as tensor code on the device: the port of
`sparrowrecsys_tpu/data/device_pipeline.py`.

`feature_pipeline.build_samples` computes the 27 columns with host numpy
segment operations; this module computes the same columns with torch
tensor operations on the card (sort, windowed moments, the
positive-history chain, the genre frequency ranking and its top 5), so
at 20M events the samples are made where training happens.
`encode_samples_device` hands them to `Trainer.fit` as tensors on the
card, with no host table in between.

Exactness: ratings lie on a 0.5 grid and travel as `2 * rating` int32,
release years as `year - YEAR_OFFSET`, so every moment sum is an integer
sum. The windowed sums difference int64 prefix sums (the JAX package's
int32 prefix sums wrap past 2^31 at 20M events and rest on the
wrap-around of the differences). `build_samples_device` recomputes the
five float columns in float64 on the host from those integer moments,
so it is bit-identical to `build_samples`; the float32 stat columns the
device also carries may differ from them by one HALF_UP step.

Ties: events of one user at one timestamp keep their input order (one
stable sort of a packed (userId, timestamp) int64 key); genres of equal
count rank lowest vocabulary index first, as `lax.top_k` and the host's
stable argsort rank them (a sort of the unique keys count * V + (V - 1 - j):
`torch.topk` promises no order among equal values).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from sparrowrecsys_torch.config import (
    NUMBER_PRECISION,
    POSITIVE_RATING_THRESHOLD,
    USER_FEATURE_WINDOW,
)
from sparrowrecsys_torch.data import feature_pipeline as fp
from sparrowrecsys_torch.data.movielens import MovieCatalog, Ratings
from sparrowrecsys_torch.data.schema import SampleTable
from sparrowrecsys_torch.utils.device import resolve_device

YEAR_OFFSET = 1950  # keeps windowed year squares small integers

#: Rows per chunk of the genre-frequency stage. Above it the [n, V] genre
#: prefix sums are taken a chunk at a time with a `window`-row halo
#: (bit-identical, see `_genre_window_topk`), so the stage's memory is
#: O(chunk * V) instead of O(n * V).
GENRE_CHUNK = 1 << 21

#: Stat columns the device carries scaled by 10^NUMBER_PRECISION
#: (integer-valued HALF_UP, see `_round_half_up_scaled`).
_SCALED_STAT_COLUMNS = (
    "movieAvgRating",
    "movieRatingStddev",
    "userAvgRating",
    "userRatingStddev",
    "userReleaseYearStddev",
)


def _round_half_up_scaled(x: torch.Tensor) -> torch.Tensor:
    """HALF_UP rounding, returned scaled by 10^precision (integer-valued
    float32). The divide by the scale happens on the host in float64, or
    in `encode_samples_device` as a true division."""
    scale = 10.0 ** NUMBER_PRECISION
    return torch.sign(x) * torch.floor(torch.abs(x) * scale + 0.5)


def _sample_std(count: torch.Tensor, total: torch.Tensor, total_sq: torch.Tensor) -> torch.Tensor:
    """Sample (n-1) stddev from integer-exact moment sums (float32 math);
    0 where count < 2."""
    cnt = count.float()
    tot = total.float()
    var = (total_sq.float() - tot * (tot / torch.clamp(cnt, min=1.0))) / torch.clamp(cnt - 1.0, min=1.0)
    std = torch.sqrt(torch.clamp(var, min=0.0))
    return torch.where(count < 2, torch.zeros_like(std), std)


def _top5_lowest_index_first(counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(counts, indices) of the 5 largest entries of each row of an [n, V]
    int tensor, equal counts by ascending index (`lax.top_k`'s order).

    The keys are unique, so any sort orders them one way; a sort of each
    short row is several times faster on the card than `torch.topk`."""
    v = counts.shape[1]
    j = torch.arange(v - 1, -1, -1, device=counts.device, dtype=torch.int64)
    key = (counts.to(torch.int64) * v + j).contiguous()
    top = torch.sort(key, dim=1, descending=True).values[:, :5]
    return (top // v).to(torch.int32), (v - 1 - top % v).to(torch.int32)


def _last_true_index(mask: torch.Tensor) -> torch.Tensor:
    """For each i, the largest j <= i with mask[j], else -1: the running
    max of the true positions (`lax.cummax` of where(mask, i, -1)). The
    rows sharing a prefix count c start at the c-th true position, so a
    scatter-min of the row indices by prefix count finds each; on an H100
    that is several times faster than `torch.cummax` (59 ms at 20M rows)."""
    count = torch.cumsum(mask, 0)
    first = torch.full((mask.shape[0] + 1,), -1, dtype=torch.int64, device=mask.device)
    first.scatter_reduce_(0, count, torch.arange(mask.shape[0], device=mask.device),
                          reduce="amin", include_self=False)
    first[0] = -1
    return first[count]


def _genre_window_topk(
    mrow_s: torch.Tensor,   # int64 [n] catalog row per sorted event, -1 = none
    label_s: torch.Tensor,  # int32 [n]
    ws: torch.Tensor,       # int64 [n] window start (sorted coords)
    genre_matrix: torch.Tensor,  # int32 [M, V] 0/1
    *,
    window: int,
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-5 (count, extended-vocab index) of the positive-window genre
    frequencies per sorted row.

    Beyond `chunk` rows the prefix sums run a chunk at a time over the
    chunk and the `window` rows before it: ws >= i - window puts every
    window start inside that halo, so the local prefix-sum differences
    equal the global ones exactly (integer sums)."""
    n = mrow_s.shape[0]
    dev = mrow_s.device
    # Genre-major [V, rows]: the prefix sums run along the innermost dim.
    # (Along dim 0 of [rows, V], PyTorch's CUDA scan gives each of the V
    # columns one sequential thread: 351 ms at 1M rows on an H100.)
    genres_by_movie = genre_matrix.T.contiguous()

    def windowed_counts(mrow, lab, ends, starts):
        genres = genres_by_movie[:, torch.clamp(mrow, min=0)] * ((mrow >= 0) & (lab == 1))
        gcs = torch.nn.functional.pad(torch.cumsum(genres, dim=1, dtype=torch.int32), (1, 0))
        return _top5_lowest_index_first((gcs[:, ends] - gcs[:, starts]).T)

    idx = torch.arange(n, device=dev)
    if n <= chunk:
        return windowed_counts(mrow_s, label_s, idx, ws)
    counts, ids = [], []
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        lo = max(start - window, 0)
        c, i = windowed_counts(mrow_s[lo:stop], label_s[lo:stop],
                               idx[start:stop] - lo, ws[start:stop] - lo)
        counts.append(c)
        ids.append(i)
    return torch.cat(counts), torch.cat(ids)


def _device_features(
    uid: torch.Tensor,           # int32 [n]
    mid: torch.Tensor,           # int32 [n]
    rating2: torch.Tensor,       # int32 [n] = 2 * rating (0.5 grid)
    ts: torch.Tensor,            # int32 [n]
    id_to_row: torch.Tensor,     # int64 [max_mid + 1], -1 = not in catalog
    release_years: torch.Tensor,  # int32 [M]
    genre_matrix: torch.Tensor,  # int32 [M, V_ext] 0/1
    movie_genre3: torch.Tensor,  # int32 [M, 3] model-vocab index / -1
    ext_to_model: torch.Tensor,  # int32 [V_ext]
    *,
    window: int,
    history_length: int,
    genre_chunk: int,
) -> Dict[str, torch.Tensor]:
    n = uid.shape[0]
    dev = uid.device
    rating = rating2.float() * 0.5
    label = (rating >= POSITIVE_RATING_THRESHOLD).to(torch.int32)

    # ---- movie join (scala:46-88) ----------------------------------------
    vm = id_to_row.shape[0]
    mid_c = torch.clamp(mid, 0, vm - 1).long()
    mrow = id_to_row[mid_c]
    has_movie = (mid >= 0) & (mid < vm) & (mrow >= 0)
    safe_mrow = torch.where(has_movie, mrow, 0)
    release_year = torch.where(has_movie, release_years[safe_mrow], 1990).to(torch.int32)
    mg = [torch.where(has_movie, movie_genre3[safe_mrow, j], -1).to(torch.int32)
          for j in range(3)]

    # Per-movie stats over all rows, grouped by the raw movieId (ids
    # outside the catalog count too, as in the host's unique(mid)).
    zeros = torch.zeros(vm, dtype=torch.int32, device=dev)
    m_cnt = zeros.index_add(0, mid_c, torch.ones_like(rating2))
    m_tot2 = zeros.index_add(0, mid_c, rating2)
    m_tot2sq = zeros.index_add(0, mid_c, rating2 * rating2)
    cnt_r = m_cnt[mid_c]
    tot_r = m_tot2[mid_c].float() * 0.5
    totsq_r = m_tot2sq[mid_c].float() * 0.25
    movie_avg = _round_half_up_scaled(tot_r / torch.clamp(cnt_r, min=1))
    movie_std = _round_half_up_scaled(_sample_std(cnt_r, tot_r, totsq_r))

    # ---- user windowed features (scala:96-142) ---------------------------
    # One stable sort of uid * 2^32 + (ts + 2^31): ordered by (uid, ts)
    # for every int32 uid and ts, inside int64; ties keep input order.
    key = uid.long() * (1 << 32) + (ts.long() + (1 << 31))
    order = torch.sort(key, stable=True).indices
    idx = torch.arange(n, device=dev)
    inv_order = torch.empty_like(order)
    inv_order[order] = idx

    uid_s = uid[order]
    mid_s = mid[order]
    rating2_s = rating2[order]
    label_s = label[order]
    yoff_s = release_year[order] - YEAR_OFFSET

    new_seg = torch.ones(n, dtype=torch.bool, device=dev)
    new_seg[1:] = uid_s[1:] != uid_s[:-1]
    seg_start = _last_true_index(new_seg)
    ws = torch.maximum(seg_start, idx - window)
    win_cnt = (idx - ws).to(torch.int32)

    def win_sum(x):
        cs = torch.cat([x.new_zeros(1, dtype=torch.int64), torch.cumsum(x, 0, dtype=torch.int64)])
        return (cs[idx] - cs[ws]).to(torch.int32)

    r2_sum = win_sum(rating2_s)
    r2_sq = win_sum(rating2_s * rating2_s)
    y_sum = win_sum(yoff_s)
    y_sq = win_sum(yoff_s * yoff_s)

    fcnt = torch.clamp(win_cnt, min=1).float()
    has_win = win_cnt > 0
    r_sum = r2_sum.float() * 0.5
    user_avg_rating = _round_half_up_scaled(torch.where(has_win, r_sum / fcnt, 0.0))
    user_avg_year = torch.where(has_win, y_sum.float() / fcnt + YEAR_OFFSET, 0.0)
    # Spark casts avg(releaseYear) to IntegerType: truncation toward zero.
    user_avg_year_i = user_avg_year.to(torch.int32)
    user_rating_std = _round_half_up_scaled(_sample_std(win_cnt, r_sum, r2_sq.float() * 0.25))
    user_year_std = _round_half_up_scaled(_sample_std(win_cnt, y_sum.float(), y_sq.float()))

    # Positive-history chain: the k-th most recent positive strictly
    # before i, inside the user's segment and the window.
    acc = _last_true_index(label_s == 1)
    prev_pos = torch.cat([acc.new_full((1,), -1), acc[:-1]])
    hists = []
    cur = prev_pos
    for _ in range(history_length):
        valid = (cur >= seg_start) & (cur >= idx - window) & (cur >= 0)
        h = torch.where(valid, cur, -1)
        hists.append(h)
        cur = torch.where(h >= 0, prev_pos[torch.clamp(h, min=0)], -1)
    hist_movies = [torch.where(h >= 0, mid_s[torch.clamp(h, min=0)], 0).to(torch.int32)
                   for h in hists]

    mrow_s = torch.where(has_movie[order], mrow[order], -1)
    top5_counts, top5 = _genre_window_topk(
        mrow_s, label_s, ws, genre_matrix, window=window, chunk=genre_chunk)
    user_genres = torch.where(top5_counts > 0, ext_to_model[top5.long()], -1).to(torch.int32)

    def back(x):  # sorted -> input order
        return x[inv_order]

    cols: Dict[str, torch.Tensor] = {
        # Integer-exact moments; the host recomputes the float columns
        # from them in float64. Underscored: not part of the 27 columns.
        "_mTot2": m_tot2[mid_c],
        "_mTot2Sq": m_tot2sq[mid_c],
        "_r2Sum": back(r2_sum),
        "_r2Sq": back(r2_sq),
        "_ySumOff": back(y_sum),
        "_ySqOff": back(y_sq),
        "movieId": mid,
        "userId": uid,
        "rating": rating,
        "timestamp": ts,
        "label": label,
        "releaseYear": release_year,
        "movieGenre1": mg[0],
        "movieGenre2": mg[1],
        "movieGenre3": mg[2],
        "movieRatingCount": cnt_r,
        "movieAvgRating": movie_avg,
        "movieRatingStddev": movie_std,
        "userRatingCount": back(win_cnt),
        "userAvgReleaseYear": back(user_avg_year_i),
        "userReleaseYearStddev": back(user_year_std),
        "userAvgRating": back(user_avg_rating),
        "userRatingStddev": back(user_rating_std),
    }
    for j in range(5):
        cols[f"userGenre{j + 1}"] = back(user_genres[:, j])
    for k in range(history_length):
        cols[f"userRatedMovie{k + 1}"] = back(hist_movies[k])
    return cols


def device_feature_columns(
    ratings: Ratings,
    catalog: MovieCatalog,
    window: int = USER_FEATURE_WINDOW,
    history_length: int = 5,
    genre_chunk: int = GENRE_CHUNK,
    device=None,
) -> Dict[str, torch.Tensor]:
    """The unfiltered feature columns as tensors on `device` (default
    `cuda`; `cuda` missing raises). Filter with `cols["userRatingCount"]
    >= k`. Timestamps travel as int32 (epoch seconds fit until 2038;
    `build_samples_device` restores int64)."""
    dev = resolve_device(device)
    _, genre_matrix, movie_genre3, ext_to_model = fp._build_genre_tables(catalog)
    mid = ratings.movie_ids.astype(np.int64)
    max_mid = int(max(catalog.movie_ids.max(), mid.max(), 0))
    id_to_row = np.full(max_mid + 1, -1, dtype=np.int64)
    id_to_row[catalog.movie_ids.astype(np.int64)] = np.arange(len(catalog))
    rating2 = np.round(ratings.ratings.astype(np.float64) * 2.0).astype(np.int32)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return _device_features(
        put(ratings.user_ids.astype(np.int32)),
        put(mid.astype(np.int32)),
        put(rating2),
        put(ratings.timestamps.astype(np.int32)),
        put(id_to_row),
        put(catalog.release_years.astype(np.int32)),
        put(genre_matrix),
        put(movie_genre3),
        put(ext_to_model),
        window=window,
        history_length=history_length,
        genre_chunk=genre_chunk,
    )


def _host_samples(dev: Dict[str, torch.Tensor], min_user_rating_count: int) -> SampleTable:
    """The device columns on the host in `build_samples`' dtypes, the float
    stat columns (and the int-cast year average) recomputed in float64
    from the integer moments with the host pipeline's formulas, filtered
    to userRatingCount >= min_user_rating_count."""
    host = {k: v.cpu().numpy() for k, v in dev.items()}
    cols: Dict[str, np.ndarray] = {}
    for k, v in host.items():
        if k.startswith("_"):
            continue
        if k in ("timestamp", "movieRatingCount", "userRatingCount"):
            cols[k] = v.astype(np.int64)
        else:
            cols[k] = v
    m_cnt = cols["movieRatingCount"].astype(np.float64)
    m_tot = host["_mTot2"].astype(np.float64) * 0.5
    m_totsq = host["_mTot2Sq"].astype(np.float64) * 0.25
    cols["movieAvgRating"] = fp._round_half_up(m_tot / np.maximum(m_cnt, 1.0)).astype(np.float32)
    cols["movieRatingStddev"] = fp._round_half_up(
        fp._sample_std(m_cnt, m_tot, m_totsq)).astype(np.float32)

    w_cnt = cols["userRatingCount"].astype(np.float64)
    r_sum = host["_r2Sum"].astype(np.float64) * 0.5
    r_sq = host["_r2Sq"].astype(np.float64) * 0.25
    # Raw-year sums from the offset ones, so the float64 arithmetic sees
    # the values the host pipeline computes.
    y_off = host["_ySumOff"].astype(np.float64)
    y_sum = y_off + w_cnt * YEAR_OFFSET
    y_sq = host["_ySqOff"].astype(np.float64) + 2.0 * YEAR_OFFSET * y_off \
        + w_cnt * float(YEAR_OFFSET) ** 2
    with np.errstate(invalid="ignore", divide="ignore"):
        uar = np.where(w_cnt > 0, r_sum / np.maximum(w_cnt, 1.0), 0.0)
        uay = np.where(w_cnt > 0, y_sum / np.maximum(w_cnt, 1.0), 0.0)
    cols["userAvgRating"] = fp._round_half_up(uar).astype(np.float32)
    cols["userAvgReleaseYear"] = uay.astype(np.int64).astype(np.int32)
    cols["userRatingStddev"] = fp._round_half_up(fp._sample_std(w_cnt, r_sum, r_sq)).astype(np.float32)
    cols["userReleaseYearStddev"] = fp._round_half_up(
        fp._sample_std(w_cnt, y_sum, y_sq)).astype(np.float32)

    keep = cols["userRatingCount"] >= min_user_rating_count
    return SampleTable({k: v[keep] for k, v in cols.items()})


def build_samples_device(
    ratings: Ratings,
    catalog: MovieCatalog,
    window: int = USER_FEATURE_WINDOW,
    min_user_rating_count: int = 2,
    history_length: int = 5,
    genre_chunk: int = GENRE_CHUNK,
    device=None,
) -> SampleTable:
    """`build_samples` computed on the device: the same columns, dtypes
    and filter, bit for bit."""
    dev = device_feature_columns(ratings, catalog, window=window,
                                 history_length=history_length,
                                 genre_chunk=genre_chunk, device=device)
    return _host_samples(dev, min_user_rating_count)


def _kept_rows(keep: torch.Tensor, n_keep: int) -> torch.Tensor:
    """The indices of the first `n_keep` true entries of `keep`, without
    a host read (each kept row's rank is its prefix count)."""
    rank = torch.cumsum(keep, 0) - 1
    slot = torch.where(keep & (rank < n_keep), rank, n_keep)
    out = torch.zeros(n_keep + 1, dtype=torch.int64, device=keep.device)
    out.scatter_(0, slot, torch.arange(keep.shape[0], device=keep.device))
    return out[:n_keep]


def encode_samples_device(
    cols: Dict[str, torch.Tensor],
    min_user_rating_count: int = 2,
    max_rows: int | None = None,
):
    """`encode_samples(build_samples(...))` with no host table: an
    EncodedDataset whose columns are tensors on the columns' device, which
    `Trainer.fit` trains on as they are. One host read, the kept-row count.

    The five 2-decimal stat columns are unscaled on the device in float32;
    against the host pipeline's float64 they can differ by one HALF_UP
    step on a few cells. `max_rows` keeps the first `max_rows` kept rows
    (`table.select(np.arange(max_rows))` on the host table)."""
    from sparrowrecsys_torch.data.dataset import (
        EncodedDataset,
        FLOAT_FEATURES,
        GENRE_FEATURES,
        INT_FEATURES,
    )

    keep = cols["userRatingCount"] >= min_user_rating_count
    n_keep = int(keep.sum())
    if max_rows is not None:
        n_keep = min(n_keep, max_rows)
    rows = _kept_rows(keep, n_keep)

    int_cols = list(INT_FEATURES) + sorted(
        (c for c in cols if c.startswith("userRatedMovie") and c not in INT_FEATURES),
        key=lambda c: int(c[len("userRatedMovie"):]),
    )
    scale = 10.0 ** NUMBER_PRECISION
    feats: Dict[str, torch.Tensor] = {}
    for c in int_cols + GENRE_FEATURES:
        feats[c] = cols[c][rows].to(torch.int32)
    for c in FLOAT_FEATURES:
        v = cols[c][rows].float()
        feats[c] = v / scale if c in _SCALED_STAT_COLUMNS else v
    return EncodedDataset(feats, cols["label"][rows].float())

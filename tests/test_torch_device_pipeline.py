"""The feature job as tensor code (`sparrowrecsys_torch/data/device_pipeline.py`)
against the JAX package's `data/device_pipeline.py` and against the port's
host `build_samples`, on the same ratings, on the CPU.

`build_samples_device` must be bit-identical to both on every column and
dtype. `encode_samples_device` carries the five 2-decimal stat columns in
float32, which may sit one HALF_UP step (0.01) from the host's float64 on a
few cells (at most max(2, n/1000) per column), as the JAX package's own
test bounds them.
"""

import os

import jax
import numpy as np
import pytest
import torch

from sparrowrecsys_torch.config import TrainConfig
from sparrowrecsys_torch.data import device_pipeline as dp
from sparrowrecsys_torch.data.dataset import EncodedDataset, encode_samples
from sparrowrecsys_torch.data.feature_pipeline import build_samples
from sparrowrecsys_torch.data.movielens import (
    MovieCatalog,
    Ratings,
    load_movies,
    ratings_from_samples_csv,
)
from sparrowrecsys_torch.data.synthetic import SyntheticSpec, synthetic_ratings
from sparrowrecsys_torch.models import build_model
from sparrowrecsys_torch.training.loop import Trainer, _same_device
from sparrowrecsys_tpu.data import device_pipeline as jdp
from sparrowrecsys_tpu.data.movielens import MovieCatalog as JCatalog
from sparrowrecsys_tpu.data.movielens import Ratings as JRatings

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")


def _jax_inputs(ratings, catalog):
    """The same ratings and catalog as the JAX package's types."""
    return (JRatings(ratings.user_ids, ratings.movie_ids, ratings.ratings, ratings.timestamps),
            JCatalog(movie_ids=catalog.movie_ids, titles=catalog.titles,
                     release_years=catalog.release_years, genres=catalog.genres,
                     id_to_row=dict(catalog.id_to_row), genre_index={}))


def _catalog(n_movies, genres=None):
    ids = np.arange(1, n_movies + 1, dtype=np.int32)
    return MovieCatalog(
        movie_ids=ids, titles=[f"M{i}" for i in ids],
        release_years=(1950 + ids % 70).astype(np.int32),
        genres=genres or [["Action", "Drama"] if i % 2 else ["Comedy"] for i in ids])


def _assert_tables_equal(got, want, ordered=True):
    """Every column equal in dtype and value; in the same order unless
    `ordered` is false (JAX's device tables come back with sorted keys)."""
    if ordered:
        assert list(got.columns) == list(want.columns)
    assert sorted(got.columns) == sorted(want.columns)
    assert len(got) == len(want)
    for k in want.columns:
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype, want[k].dtype)
        assert int(np.sum(got[k] != want[k])) == 0, k


@pytest.fixture(scope="module")
def bundled():
    return (ratings_from_samples_csv(os.path.join(DATA, "goldenTestSamples.csv")),
            load_movies(os.path.join(DATA, "movies.csv")))


def _awkward():
    """5,003 events of 7 heavy users over 40 movies: the chunk size 512
    does not divide n, and each user's window rides the halo across many
    chunk boundaries."""
    rng = np.random.default_rng(7)
    n = 5003
    ratings = Ratings(
        user_ids=np.sort(rng.integers(1, 8, n)).astype(np.int32),
        movie_ids=rng.integers(1, 40, n).astype(np.int32),
        ratings=(rng.integers(1, 11, n) * 0.5).astype(np.float32),
        timestamps=rng.permutation(n).astype(np.int64),
    )
    return ratings, _catalog(40)


def _tied_genres():
    """Positive histories whose genre counts tie: every movie has one
    genre, and the later-watched movies carry the lower vocabulary index,
    so first-seen order and index order disagree; ties rank by index."""
    genres = [["Musical"], ["Children"], ["Mystery"], ["Drama"], ["Comedy"], ["War"],
              ["Romance"], ["Horror"], ["Adventure"], ["Action"]]
    rng = np.random.default_rng(3)
    n = 3000
    uid = rng.integers(1, 30, n).astype(np.int32)
    return Ratings(
        user_ids=uid, movie_ids=rng.integers(1, 11, n).astype(np.int32),
        ratings=np.full(n, 4.0, np.float32),
        timestamps=rng.permutation(n).astype(np.int64),
    ), _catalog(10, genres)


CASES = {
    "bundled": (lambda b: b, {}),
    "synthetic_100k": (lambda b: (synthetic_ratings(SyntheticSpec(2000, 500, 100_000)),
                                  _catalog(500)), {}),
    "history16": (lambda b: b, {"history_length": 16}),
    "chunk1000": (lambda b: b, {"genre_chunk": 1000}),
    "awkward_chunk512": (lambda b: _awkward(), {"genre_chunk": 512}),
    "tied_genres": (lambda b: _tied_genres(), {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_build_samples_device_bit_equal_to_host_and_jax(case, bundled):
    make, kw = CASES[case]
    ratings, catalog = make(bundled)
    want = build_samples(ratings, catalog,
                         history_length=kw.get("history_length", 5))
    got = dp.build_samples_device(ratings, catalog, device="cpu", **kw)
    _assert_tables_equal(got, want)
    jax_table = jdp.build_samples_device(*_jax_inputs(ratings, catalog), **kw)
    _assert_tables_equal(got, jax_table, ordered=False)
    if case == "tied_genres":
        assert _rows_with_tied_top5(ratings) > 1000


def _rows_with_tied_top5(ratings, window=100):
    """Rows of the tied-genres case whose window holds two genres of equal
    nonzero count among its top 5 (movie m has the one genre m - 1, and
    every rating is positive)."""
    uid, mid = ratings.user_ids, ratings.movie_ids
    order = np.lexsort((np.arange(len(uid)), ratings.timestamps, uid))
    tied = 0
    for u in np.unique(uid):
        seq = mid[order][uid[order] == u]
        for i in range(len(seq)):
            counts = np.bincount(seq[max(0, i - window):i], minlength=11)[1:]
            top = np.sort(counts)[::-1][:5]
            top = top[top > 0]
            tied += len(np.unique(top)) < len(top)
    return tied


def test_top5_ties_rank_like_lax_top_k():
    counts = np.random.default_rng(0).integers(0, 3, (500, 23)).astype(np.int32)
    vals, idx = dp._top5_lowest_index_first(torch.from_numpy(counts))
    jvals, jidx = jax.lax.top_k(counts, 5)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("p_true", [0.0, 0.02, 0.5, 1.0])
def test_last_true_index_is_lax_cummax(p_true):
    mask = np.random.default_rng(2).random(3000) < p_true
    got = dp._last_true_index(torch.from_numpy(mask)).numpy()
    want = jax.lax.cummax(np.where(mask, np.arange(3000), -1), axis=0)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("uid_sign", [1, -1])
def test_packed_sort_key_orders_any_uid_sign_and_late_timestamps(uid_sign):
    """uid * 2^32 + ts + 2^31 sorts as (uid, ts, input order) for negative
    ids and timestamps up to 2^31 - 1."""
    rng = np.random.default_rng(1)
    n = 4000
    uid = (uid_sign * rng.integers(0, 2**31 - 1, n)).astype(np.int32)
    uid[: n // 4] = uid[n // 4: n // 2]  # repeated users
    ts = rng.integers(2**31 - 50, 2**31 - 1, n).astype(np.int32)
    ts[::7] = -2**31
    key = torch.from_numpy(uid).long() * (1 << 32) + (torch.from_numpy(ts).long() + (1 << 31))
    order = torch.sort(key, stable=True).indices.numpy()
    np.testing.assert_array_equal(order, np.lexsort((np.arange(n), ts, uid)))


def test_windowed_sums_stay_exact_past_int32():
    """Release years 3,000 past the offset: each event adds 9e6 to the
    year-square prefix sum, which passes 2^31 within 240 events of one
    user, while every 100-event window sum stays below it. The int64
    prefix sums give the exact window sums; JAX's int32 prefix sums wrap
    and give the same, by modular arithmetic."""
    n = 600
    rng = np.random.default_rng(5)
    ratings = Ratings(np.ones(n, np.int32), rng.integers(1, 4, n).astype(np.int32),
                      np.full(n, 4.0, np.float32), np.arange(n, dtype=np.int64))
    catalog = _catalog(3)
    catalog.release_years[:] = dp.YEAR_OFFSET + 3000
    yoff_sq = np.full(n, 3000 ** 2, np.int64)
    assert yoff_sq.sum() > 2**31
    cols = dp.device_feature_columns(ratings, catalog, device="cpu")
    prefix = np.concatenate([[0], np.cumsum(yoff_sq)])
    idx = np.arange(n)
    want = prefix[idx] - prefix[np.maximum(idx - 100, 0)]
    np.testing.assert_array_equal(cols["_ySqOff"].numpy(), want)
    jcols = jdp.device_feature_columns(*_jax_inputs(ratings, catalog))
    np.testing.assert_array_equal(cols["_ySqOff"].numpy(), np.asarray(jcols["_ySqOff"]))
    _assert_tables_equal(dp.build_samples_device(ratings, catalog, device="cpu"),
                         build_samples(ratings, catalog))


def _assert_encoded_close(got, want):
    """Ints and labels equal; float columns within one HALF_UP step on at
    most max(2, n/1000) cells (tests/test_device_pipeline.py:142-152)."""
    assert set(got.features) == set(want.features)
    assert len(got) == len(want)
    np.testing.assert_array_equal(np.asarray(got.labels), np.asarray(want.labels))
    for k, wv in want.features.items():
        gv = np.asarray(got.features[k])
        assert gv.dtype == np.asarray(wv).dtype, k
        if gv.dtype == np.float32:
            diff = np.abs(gv - np.asarray(wv))
            assert diff.max() <= 0.01 + 1e-6, k
            assert int(np.sum(diff > 1e-6)) <= max(2, len(gv) // 1000), k
        else:
            np.testing.assert_array_equal(gv, np.asarray(wv), err_msg=k)


def test_encode_samples_device_against_host_and_jax(bundled):
    ratings, catalog = bundled
    cols = dp.device_feature_columns(ratings, catalog, device="cpu")
    got = dp.encode_samples_device(cols)
    assert isinstance(got.labels, torch.Tensor)
    assert all(isinstance(v, torch.Tensor) for v in got.features.values())
    host = encode_samples(build_samples(ratings, catalog))
    _assert_encoded_close(got, host)
    jgot = jdp.encode_samples_device(jdp.device_feature_columns(*_jax_inputs(ratings, catalog)))
    jax_ds = EncodedDataset({k: np.asarray(v) for k, v in jgot.features.items()},
                            np.asarray(jgot.labels))
    _assert_encoded_close(got, jax_ds)


def test_encode_samples_device_max_rows(bundled):
    ratings, catalog = bundled
    table = build_samples(ratings, catalog)
    host = encode_samples(table.select(np.arange(1000)))
    got = dp.encode_samples_device(dp.device_feature_columns(ratings, catalog, device="cpu"),
                                   max_rows=1000)
    assert len(got) == 1000
    for k in ("movieId", "userId", "userRatedMovie1", "userGenre1"):
        np.testing.assert_array_equal(got.features[k].numpy(), host.features[k])
    np.testing.assert_array_equal(got.labels.numpy(), host.labels)


def test_trainer_fits_the_tensor_dataset_as_the_numpy_one(bundled):
    """Trainer.fit takes the tensor columns as they are; the same rows as
    numpy arrays train to the same parameters, bit for bit."""
    ratings, catalog = bundled
    ds = dp.encode_samples_device(dp.device_feature_columns(ratings, catalog, device="cpu"),
                                  max_rows=2048)
    np_ds = EncodedDataset({k: v.numpy().copy() for k, v in ds.features.items()},
                           ds.labels.numpy().copy())
    cfg = TrainConfig(batch_size=512, epochs=1)
    results = []
    for data in (ds, np_ds):
        trainer = Trainer(build_model("deepfm"), cfg, device="cpu")
        results.append(trainer.fit(data, params=trainer.init_params(seed=0), verbose=False))
    assert np.isfinite(results[0].history[-1]["loss"])
    for k, v in results[0].params.items():
        assert torch.equal(v, results[1].params[k]), k


@pytest.mark.parametrize("current, want", [(0, True), (1, False)])
def test_card_columns_count_as_on_the_default_device(monkeypatch, current, want):
    """The trainer's default `cuda` has no index while a card tensor's
    device is `cuda:0`: they are one device when card 0 is current, so
    `Trainer._columns` keeps card-built columns where they are instead of
    copying them to the host past `device_resident_bytes`."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    assert torch.device("cuda:0") != torch.device("cuda")
    assert _same_device(torch.device("cuda:0"), torch.device("cuda")) is want
    assert _same_device(torch.device("cuda:1"), torch.device("cuda:1"))
    assert _same_device(torch.device("cpu"), torch.device("cpu"))
    assert not _same_device(torch.device("cpu"), torch.device("cuda"))


def test_columns_need_cuda_unless_the_cpu_is_asked_for(bundled):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dp.device_feature_columns(*bundled)

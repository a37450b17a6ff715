"""The host feature pipeline in the port (`data/feature_pipeline.py`,
`data/transforms.py`, `data/schema.py`, `data/movielens.py`,
`data/synthetic.py::synthetic_ratings`, `data/run.py` and the write side
of `serving/feature_store.py`) against the JAX package's, on the same
inputs. Everything here is numpy on the host, so every comparison is
exact: columns bit-equal, files byte-equal, stores equal as parsed
objects."""

import json
import os
import sys
import time

import numpy as np
import pytest

from sparrowrecsys_torch.config import GENRE_VOCAB
from sparrowrecsys_torch.data import run as data_run
from sparrowrecsys_torch.data import transforms as T
from sparrowrecsys_torch.data.feature_pipeline import build_samples, split_samples
from sparrowrecsys_torch.data.movielens import (
    MovieCatalog,
    load_movies,
    load_ratings,
    ratings_from_samples_csv,
    write_ratings_csv,
)
from sparrowrecsys_torch.data.synthetic import SyntheticSpec, synthetic_ratings
from sparrowrecsys_torch.serving.feature_store import FeatureStore, export_sample_features
from sparrowrecsys_tpu.data import run as jax_data_run
from sparrowrecsys_tpu.data import transforms as JT
from sparrowrecsys_tpu.data.feature_pipeline import build_samples as jax_build_samples
from sparrowrecsys_tpu.data.feature_pipeline import split_samples as jax_split_samples
from sparrowrecsys_tpu.data.movielens import load_movies as jax_load_movies
from sparrowrecsys_tpu.data.movielens import ratings_from_samples_csv as jax_ratings_from_samples
from sparrowrecsys_tpu.data.synthetic import SyntheticSpec as JaxSyntheticSpec
from sparrowrecsys_tpu.data.synthetic import synthetic_ratings as jax_synthetic_ratings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")
#: mf: + uf: keys of the bundled job's feature_store.json (725 movies,
#: 2,492 users); chip_smoke.py's offline phase pins the same count.
STORE_KEYS = 3217


def _assert_columns_equal(got, want):
    assert list(got.columns) == list(want.columns)
    for k in want.columns:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def golden():
    """(port table, JAX table) from the ratings of goldenTestSamples.csv."""
    path = os.path.join(DATA, "goldenTestSamples.csv")
    ratings, jratings = ratings_from_samples_csv(path), jax_ratings_from_samples(path)
    for a in ("user_ids", "movie_ids", "ratings", "timestamps"):
        np.testing.assert_array_equal(getattr(ratings, a), getattr(jratings, a))
    table = build_samples(ratings, load_movies(os.path.join(DATA, "movies.csv")))
    jtable = jax_build_samples(jratings, jax_load_movies(os.path.join(DATA, "movies.csv")))
    return table, jtable


def test_build_samples_is_bit_equal_to_jax_on_the_golden_ratings(golden):
    table, jtable = golden
    assert len(table) == len(jtable) > 4000
    _assert_columns_equal(table, jtable)


@pytest.mark.parametrize("kwargs", [
    {}, {"by_time": True}, {"sample_fraction": 0.3, "train_fraction": 0.7, "seed": 5},
], ids=["random", "by_time", "sampled"])
def test_split_samples_and_to_csv_match_jax(golden, kwargs, tmp_path):
    table, jtable = golden
    (tr, te), (jtr, jte) = split_samples(table, **kwargs), jax_split_samples(jtable, **kwargs)
    _assert_columns_equal(tr, jtr)
    _assert_columns_equal(te, jte)
    tr.to_csv(str(tmp_path / "port.csv"), GENRE_VOCAB)
    jtr.to_csv(str(tmp_path / "jax.csv"), GENRE_VOCAB)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def test_feature_job_reproduces_the_bundled_samples_and_the_jax_store(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1.7e9)     # equal expiry epochs
    data_run.main(["--out-dir", str(tmp_path / "port"), "--export-features"])
    monkeypatch.setattr(sys, "argv", ["run", "--out-dir", str(tmp_path / "jax"),
                                      "--export-features"])
    jax_data_run.main()
    for name in ("trainingSamples.csv", "testSamples.csv"):
        with open(os.path.join(DATA, name), "rb") as f:
            assert (tmp_path / "port" / name).read_bytes() == f.read(), name
    got = json.loads((tmp_path / "port" / "feature_store.json").read_text())
    want = json.loads((tmp_path / "jax" / "feature_store.json").read_text())
    assert got == want
    assert len(got["hashes"]) == len(got["expiry"]) == STORE_KEYS
    store = FeatureStore.load(str(tmp_path / "port" / "feature_store.json"))
    for key in ("mf:1", next(k for k in got["hashes"] if k.startswith("uf:"))):
        assert store.hgetall(key) == got["hashes"][key]


def test_feature_job_native_loader_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        data_run.main(["--native"])


def test_ratings_csv_round_trips_byte_for_byte(tmp_path):
    path = os.path.join(DATA, "ratings.csv")
    ratings = load_ratings(path)
    assert len(ratings) == 22440
    out = str(tmp_path / "ratings.csv")
    write_ratings_csv(ratings, out)
    with open(path, "rb") as f:
        assert open(out, "rb").read() == f.read()


def test_synthetic_ratings_are_bit_equal_to_jax():
    spec = dict(n_users=300, n_movies=200, n_events=5000, seed=11)
    got, want = synthetic_ratings(SyntheticSpec(**spec)), jax_synthetic_ratings(
        JaxSyntheticSpec(**spec))
    for a in ("user_ids", "movie_ids", "ratings", "timestamps"):
        assert getattr(got, a).dtype == getattr(want, a).dtype, a
        np.testing.assert_array_equal(getattr(got, a), getattr(want, a), err_msg=a)
    assert SyntheticSpec() == SyntheticSpec(**JaxSyntheticSpec().__dict__)


def test_build_samples_on_a_catalog_without_id_to_row_matches_jax():
    """The catalog `chip_smoke.py` builds for the timed job (synthetic
    events on a catalog of every movie id), at a small spec."""
    from sparrowrecsys_tpu.data.movielens import MovieCatalog as JaxMovieCatalog

    ids = np.arange(1, 201, dtype=np.int32)
    cols = dict(movie_ids=ids, titles=[f"Movie {i}" for i in ids],
                release_years=(1950 + ids % 70).astype(np.int32),
                genres=[["Action", "Drama"] if i % 2 else ["Comedy"] for i in ids])
    catalog = MovieCatalog(**cols)
    assert catalog.row(1) == 0 and catalog.row(0) is None
    jcatalog = JaxMovieCatalog(**cols, id_to_row={int(i): k for k, i in enumerate(ids)},
                               genre_index={})
    spec = dict(n_users=300, n_movies=200, n_events=5000)
    _assert_columns_equal(build_samples(synthetic_ratings(SyntheticSpec(**spec)), catalog),
                          jax_build_samples(jax_synthetic_ratings(JaxSyntheticSpec(**spec)),
                                            jcatalog))


def test_transforms_match_jax():
    rng = np.random.default_rng(0)
    values = rng.integers(-2, 12, 50)
    np.testing.assert_array_equal(T.one_hot(values, 10), JT.one_hot(values, 10))
    genres = [list(rng.choice(GENRE_VOCAB[:6], size=rng.integers(0, 4), replace=False))
              for _ in range(40)]
    (mh, idx), (jmh, jidx) = T.multi_hot(genres), JT.multi_hot(genres)
    np.testing.assert_array_equal(mh, jmh)
    assert idx.labels == jidx.labels
    np.testing.assert_array_equal(idx.transform(["Action", "nope"]),
                                  jidx.transform(["Action", "nope"]))
    x = rng.normal(size=500)
    qd, jqd = T.QuantileDiscretizer.fit(x, 20), JT.QuantileDiscretizer.fit(x, 20)
    np.testing.assert_array_equal(qd.splits, jqd.splits)
    np.testing.assert_array_equal(qd.transform(x), jqd.transform(x))
    cols = np.stack([x, np.full(500, 3.0)], axis=1)
    np.testing.assert_array_equal(T.MinMaxScaler.fit(cols).transform(cols),
                                  JT.MinMaxScaler.fit(cols).transform(cols))
    mids = rng.integers(1, 30, 300)
    r = rng.integers(1, 11, 300) / 2.0
    got, want = T.movie_rating_stats(mids, r), JT.movie_rating_stats(mids, r)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---- the store's semantics, as tests/test_feature_store.py holds the JAX one's

def test_store_hash_round_trip_and_ttl():
    s = FeatureStore()
    s.hset("mf:1", {"a": 1}, ttl=1000)
    assert s.hgetall("mf:1") == {"a": "1"}
    s.hset("mf:2", {"b": "2"}, ttl=0.01)
    time.sleep(0.05)
    assert s.hgetall("mf:2") is None
    s.hset("mf:3", {"c": "3"}, ttl=0.01)
    s.hset("mf:3", {"c": "4"})                     # no TTL clears the expiry
    time.sleep(0.05)
    assert s.hgetall("mf:3") == {"c": "4"}


def test_store_string_keys_and_persistence(tmp_path):
    s = FeatureStore()
    s.set("uEmb:7", "1.0 2.0", ttl=1000)
    assert s.get("uEmb:7") == "1.0 2.0" and s.get("missing") is None
    s.hset("uf:3", {"userAvgRating": "3.50"})
    s.hset("mf:9", {"x": "1"}, ttl=0.05)
    path = str(tmp_path / "store.json")
    s.save(path)
    loaded = FeatureStore.load(path)
    assert loaded.hgetall("uf:3") == {"userAvgRating": "3.50"}
    assert loaded.get("uEmb:7") == "1.0 2.0"
    assert loaded.hgetall("mf:9") == {"x": "1"}
    time.sleep(0.1)
    assert loaded.hgetall("mf:9") is None          # the expiry travelled with the file


def test_store_export_latest_row_wins(tmp_path):
    ratings = ratings_from_samples_csv(os.path.join(DATA, "goldenTestSamples.csv"))
    table = build_samples(ratings, load_movies(os.path.join(DATA, "movies.csv")))
    store = FeatureStore()
    export_sample_features(table, GENRE_VOCAB, store)
    uid = int(table["userId"][0])
    rows = np.flatnonzero(table["userId"] == uid)
    ts = table["timestamp"][rows]
    latest = rows[ts == ts.max()][-1]                # ties: the later row
    uf = store.hgetall(f"uf:{uid}")
    assert uf["userRatingCount"] == str(int(table["userRatingCount"][latest]))
    assert uf["userAvgRating"] == f"{float(table['userAvgRating'][latest]):.2f}"

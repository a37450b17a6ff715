"""The serving functions no endpoint calls, against the JAX package's on the
bundled catalog with its embeddings: `SimilarMovieProcess.
multiple_retrieval_candidates` and `retrieval_candidates_by_embedding`
(descending, the JAX package's recorded divergence from the Java),
`DataManager.load_feature_store` with `Movie.movie_features` and
`User.user_features`, and `FeatureAssembler.example_features`."""

import os

import numpy as np
import pytest
import torch

from sparrowrecsys_torch.models.dien import NEGATIVE_COLS
from sparrowrecsys_torch.serving.assembler import FeatureAssembler as TAssembler
from sparrowrecsys_torch.serving.catalog import DataManager as TDataManager
from sparrowrecsys_torch.serving.feature_store import FeatureStore as TStore
from sparrowrecsys_torch.serving.processes import SimilarMovieProcess as TSimilar
from sparrowrecsys_tpu.serving.assembler import FeatureAssembler as JAssembler
from sparrowrecsys_tpu.serving.catalog import DataManager as JDataManager
from sparrowrecsys_tpu.serving.feature_store import FeatureStore as JStore
from sparrowrecsys_tpu.serving.processes import SimilarMovieProcess as JSimilar

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")
STORE = os.path.join(DATA, "feature_store.json")
#: Movies with embeddings and one to five genres; 1 is the endpoints' own.
MOVIES = (1, 2, 158, 296, 593, 780)


def _files():
    return (f"{DATA}/movies.csv", f"{DATA}/links.csv", f"{DATA}/ratings.csv",
            f"{DATA}/modeldata/item2vecEmb.csv", f"{DATA}/modeldata/userEmb.csv")


@pytest.fixture(scope="module")
def catalogs():
    return JDataManager().load_data(*_files()), TDataManager().load_data(*_files())


def _ids(movies):
    return None if movies is None else [m.movie_id for m in movies]


@pytest.mark.parametrize("movie_id", MOVIES)
def test_multiple_retrieval_candidates_match_jax(catalogs, movie_id):
    jdm, tdm = catalogs
    got = TSimilar(tdm, "cpu").multiple_retrieval_candidates(tdm.get_movie_by_id(movie_id))
    want = JSimilar(jdm).multiple_retrieval_candidates(jdm.get_movie_by_id(movie_id))
    assert _ids(got) == _ids(want)
    assert movie_id not in _ids(got) and len(got) >= 100


@pytest.mark.parametrize("movie_id", MOVIES)
@pytest.mark.parametrize("size", [1, 16, 5000])
def test_retrieval_candidates_by_embedding_match_jax_best_first(catalogs, movie_id, size):
    jdm, tdm = catalogs
    movie = tdm.get_movie_by_id(movie_id)
    assert movie.emb is not None
    got = TSimilar(tdm, "cpu").retrieval_candidates_by_embedding(movie, size)
    want = JSimilar(jdm).retrieval_candidates_by_embedding(jdm.get_movie_by_id(movie_id), size)
    assert _ids(got) == _ids(want)
    assert len(got) == min(size, len(tdm.movies))
    # Descending cosine: the most similar first (the movie itself, score 1).
    assert got[0].movie_id == movie_id


def test_retrieval_candidates_by_embedding_without_one_is_none(catalogs):
    jdm, tdm = catalogs
    movie = tdm.get_movie_by_id(1)
    bare = type(movie)(movie.movie_id)
    assert TSimilar(tdm, "cpu").retrieval_candidates_by_embedding(bare, 5) is None
    assert JSimilar(jdm).retrieval_candidates_by_embedding(type(jdm.get_movie_by_id(1))(1), 5) \
        is None
    assert TSimilar(tdm, "cpu").retrieval_candidates_by_embedding(None, 5) is None


@pytest.mark.parametrize("source", ["store", "path"])
def test_load_feature_store_attaches_jax_hashes(catalogs, source, capsys):
    jdm, tdm = catalogs
    if source == "store":
        tdm.load_feature_store(TStore.load(STORE))
        jdm.load_feature_store(JStore.load(STORE))
    else:
        tdm.load_feature_store(STORE)
        jdm.load_feature_store(STORE)
    got_m = {k: m.movie_features for k, m in tdm.movies.items()}
    want_m = {k: m.movie_features for k, m in jdm.movies.items()}
    got_u = {k: u.user_features for k, u in tdm.users.items()}
    want_u = {k: u.user_features for k, u in jdm.users.items()}
    assert got_m == want_m and got_u == want_u
    assert sum(v is not None for v in got_m.values()) > 500
    assert sum(v is not None for v in got_u.values()) > 100
    # Movie JSON carries no features, in both packages.
    assert "movie_features" not in tdm.get_movie_by_id(1).to_json()


@pytest.mark.parametrize("load_movie, load_user", [(True, False), (False, True)])
def test_load_feature_store_sides(load_movie, load_user, capsys):
    """The `test_feature_store.py::test_catalog_attachment` case on one
    movie and one user of the bundled store, each side alone."""
    from sparrowrecsys_torch.serving.catalog import Movie, User

    store = TStore.load(STORE)
    dm = TDataManager()
    dm.movies[1], dm.users[23843] = Movie(1), User(23843)
    assert store.hgetall("mf:1") is not None and store.hgetall("uf:23843") is not None
    dm.load_feature_store(store, load_movie=load_movie, load_user=load_user)
    assert dm.movies[1].movie_features == (store.hgetall("mf:1") if load_movie else None)
    assert dm.users[23843].user_features == (store.hgetall("uf:23843") if load_user else None)


@pytest.mark.parametrize("n", [1, 2, 7])
@pytest.mark.parametrize("extra", [(), NEGATIVE_COLS])
def test_example_features_match_jax(n, extra):
    got = TAssembler(TStore()).example_features(n, extra)
    want = JAssembler(JStore()).example_features(n, extra)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape == (n,), k
        np.testing.assert_array_equal(got[k], v)

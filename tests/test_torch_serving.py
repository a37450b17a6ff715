"""The port's serving plane against the JAX server, end to end on the CPU.

Both servers load the same `data/` files and exports in one process.
Catalog endpoints must give byte-equal bodies. Ranked endpoints must
give the same movie order; two neighbours may trade places only where
the JAX scores of the two movies differ by less than TIE_TOL, since two
float32 implementations may break such near-ties either way.

DeepFMv2 adds its FM cross's own float32 rounding noise to that
(`_fm_logit_noise`, computed from the JAX reference's fields and weights,
never from the port's): with the shipped export's raw numerics,
(sum x)^2 - sum x^2 cancels terms near 1e5, so two float32 evaluations
of one model disagree far beyond 1e-6, and a pair of movies may trade
places when their JAX scores are closer than both movies' noise.
"""

import json
import os
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparrowrecsys_torch.config import ServingConfig as TServingConfig
from sparrowrecsys_torch.models import build_model as torch_build
from sparrowrecsys_torch.serving.assembler import FeatureAssembler as TAssembler
from sparrowrecsys_torch.serving.catalog import DataManager as TDataManager
from sparrowrecsys_torch.serving.feature_store import FeatureStore as TStore
from sparrowrecsys_torch.serving.rankers import ModelScorer as TScorer
from sparrowrecsys_torch.serving.server import RecSysServer as TServer
from sparrowrecsys_tpu.config import ServingConfig as JServingConfig
from sparrowrecsys_tpu.models import build_model as jax_build
from sparrowrecsys_tpu.ops.topk import cosine_scores as jax_cosine
from sparrowrecsys_tpu.serving.assembler import FeatureAssembler as JAssembler
from sparrowrecsys_tpu.serving.catalog import DataManager as JDataManager
from sparrowrecsys_tpu.serving.feature_store import FeatureStore as JStore
from sparrowrecsys_tpu.serving.rankers import ModelScorer as JScorer
from sparrowrecsys_tpu.serving.rankers import cosine_scores_batch as jax_cosine_batch
from sparrowrecsys_tpu.serving.server import RecSysServer as JServer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")
MODELS = ("din", "deepfm_v2")
#: JAX-score gap under which two neighbours may trade places.
TIE_TOL = 1e-6
#: Users with ratings and embeddings; 27 has none and ranks nothing.
USERS = (14887, 11888, 2, 25878, 11434)


def _files():
    return (f"{DATA}/movies.csv", f"{DATA}/links.csv", f"{DATA}/ratings.csv",
            f"{DATA}/modeldata/item2vecEmb.csv", f"{DATA}/modeldata/userEmb.csv")


@pytest.fixture(scope="module")
def servers():
    jdm = JDataManager().load_data(*_files())
    tdm = TDataManager().load_data(*_files())
    jasm = JAssembler(JStore.load(f"{DATA}/feature_store.json"), jdm)
    tasm = TAssembler(TStore.load(f"{DATA}/feature_store.json"), tdm)
    jscorers = {m: JScorer.from_checkpoint(jax_build(m), f"{DATA}/modeldata/{m}",
                                           assembler=jasm) for m in MODELS}
    tscorers = {m: TScorer.from_checkpoint(torch_build(m), f"{DATA}/modeldata/{m}",
                                           tasm, device="cpu") for m in MODELS}
    jserver = JServer(jdm, JServingConfig(port=0, model_batch=2, model_poll_s=0),
                      scorers=jscorers)
    tserver = TServer(tdm, TServingConfig(port=0, model_batch=2, model_poll_s=0),
                      scorers=tscorers, device="cpu")
    return jserver, tserver


def _get(server, path, **params):
    status, ctype, body = server.handle(path, lambda k, d="": str(params.get(k, d)))
    assert status == 200
    return body


def _ids(body):
    return [m["movieId"] for m in json.loads(body)]


def _assert_same_order(got, ref, ref_score, slack=None):
    """`got` (movie ids, best first) holds the movies of `ref` and inverts
    no pair whose reference scores differ by TIE_TOL plus both movies'
    `slack` or more. With no slack this is `ref`'s order up to swaps of
    near-ties."""
    assert sorted(got) == sorted(ref)
    score = np.array([ref_score[m] for m in got])
    tol = TIE_TOL + np.array([(slack or {}).get(m, 0.0) for m in got])
    # i ranked before j (i < j) while the reference clearly prefers j:
    clear = (score[None, :] - score[:, None]) >= tol[:, None] + tol[None, :]
    bad = np.argwhere(np.triu(clear, 1))
    assert len(bad) == 0, [(got[i], got[j]) for i, j in bad[:5]]


def _fm_logit_noise(fields, w_out):
    """Float32 rounding noise the FM cross puts into each logit, [B], from
    the fields [B, F, D] and the output layer's FM weights [D].

    With raw numerics (releaseYear near 2000) one field is in the
    hundreds, and (sum x)^2 - sum x^2 cancels terms near 1e5: each element
    carries roundings of size u ((sum_f |x_f|)^2 + sum_f x_f^2),
    u = 2**-24. Two float32 evaluations (JAX and the port) differ by about
    this much: two roundings per element, added over D with random signs
    (root-sum-square), weighted by the output layer."""
    x = np.asarray(fields, np.float64)
    size = np.abs(x).sum(1) ** 2 + (x * x).sum(1)
    return 2 * 2.0 ** -24 * np.sqrt(((size * np.abs(w_out)) ** 2).sum(1))


def _fm_noise(jscorer, user, cand_ids, monkeypatch):
    """DeepFMv2's FM rounding noise per candidate, as a probability (the
    sigmoid's slope is at most 1/4), from the fields the JAX reference
    feeds its FM cross (caught on their way in) and its output layer."""
    import sparrowrecsys_tpu.models.deepfm as jax_deepfm

    seen = []
    fm = jax_deepfm.fm_cross
    feats = jscorer.assembler.features(user, np.asarray(cand_ids, np.int32))
    with monkeypatch.context() as m:
        m.setattr(jax_deepfm, "fm_cross", lambda x: (seen.append(np.asarray(x)), fm(x))[1])
        jscorer.model.apply({"params": jscorer.params},
                            {k: jnp.asarray(v) for k, v in feats.items()})
    (fields,) = seen
    w_out = np.asarray(jscorer.params["out"]["kernel"])[1:1 + fields.shape[-1], 0]
    return 0.25 * _fm_logit_noise(fields, w_out)


@pytest.mark.parametrize("path,params", [
    ("/getmovie", {"id": 1}), ("/getmovie", {"id": 589}), ("/getmovie", {"id": 999999}),
    ("/getuser", {"id": 14887}), ("/getuser", {"id": 2}), ("/getuser", {"id": 0}),
    ("/getrecforyou", {"id": 27, "size": 10, "model": "din"}),
    ("/getrecommendation", {"genre": "Action", "size": 8, "sortby": "rating"}),
    ("/getrecommendation", {"genre": "Comedy", "size": 50, "sortby": "releaseYear"}),
    ("/getrecommendation", {"genre": "NoSuchGenre", "size": 5, "sortby": "rating"}),
    ("/getsimilarmovie", {"movieId": 1, "size": 16, "model": "default"}),
    ("/getrecforyou", {"id": 14887, "size": 20, "model": "unknown"}),
])
def test_catalog_endpoints_byte_equal(servers, path, params):
    jserver, tserver = servers
    assert _get(tserver, path, **params) == _get(jserver, path, **params)


@pytest.mark.parametrize("movie_id", [1, 260, 589])
def test_similar_movie_emb_order(servers, movie_id):
    jserver, tserver = servers
    params = dict(movieId=movie_id, size=1000, model="emb")
    ref = _ids(_get(jserver, "/getsimilarmovie", **params))
    got = _ids(_get(tserver, "/getsimilarmovie", **params))
    dm = jserver.dm
    movie = dm.get_movie_by_id(movie_id)
    mat = np.stack([dm.movie_emb_matrix[dm.movie_emb_row(m)] if dm.movie_emb_row(m) >= 0
                    else np.zeros(dm.movie_emb_matrix.shape[1], np.float32) for m in ref])
    scores = jax_cosine_batch(np.asarray(movie.emb, np.float32), mat)
    _assert_same_order(got, ref, dict(zip(ref, scores.tolist())))


@pytest.mark.parametrize("user", USERS)
def test_rec_for_you_emb_order(servers, user):
    jserver, tserver = servers
    ref = _ids(_get(jserver, "/getrecforyou", id=user, size=800, model="emb"))
    got = _ids(_get(tserver, "/getrecforyou", id=user, size=800, model="emb"))
    cands, mat = jserver.rec_for_you._candidate_set()
    dm = jserver.dm
    row = dm.user_emb_row(user)
    if row < 0:
        assert got == ref
        return
    q = dm.user_emb_matrix[row][None, :]
    scores = np.asarray(jax_cosine(jnp.asarray(q), jnp.asarray(mat)))[0]
    _assert_same_order(got, ref, {c.movie_id: s for c, s in zip(cands, scores.tolist())})


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("user", USERS)
def test_rec_for_you_model_order(servers, model, user, monkeypatch):
    jserver, tserver = servers
    ref = _ids(_get(jserver, "/getrecforyou", id=user, size=800, model=model))
    got = _ids(_get(tserver, "/getrecforyou", id=user, size=800, model=model))
    assert len(ref) == 800
    cands, _ = jserver.rec_for_you._candidate_set()
    cand_ids = [c.movie_id for c in cands]
    jscorer = jserver.rec_for_you.scorers[model]
    jscores = jscorer.score(user, cand_ids)
    tscores = tserver.rec_for_you.scorers[model].score(user, cand_ids)
    fm = (_fm_noise(jscorer, user, cand_ids, monkeypatch) if model == "deepfm_v2"
          else np.zeros(800))
    # 2.5e-5: the export logits' 1e-4 (test_torch_models) times slope 1/4.
    assert np.all(np.abs(tscores - jscores) <= 2.5e-5 + 2 * fm)
    _assert_same_order(got, ref, dict(zip(cand_ids, jscores.tolist())),
                       dict(zip(cand_ids, fm.tolist())))


def test_wave_scores_equal_single_scores(servers):
    _, tserver = servers
    scorer = tserver.rec_for_you.scorers["din"]
    cands, _ = tserver.rec_for_you._candidate_set()
    cand_ids = [c.movie_id for c in cands][:50]
    scorer.prepare_wave(cand_ids, 3)
    wave = scorer.score_wave([USERS[0], USERS[1], USERS[0]])
    np.testing.assert_allclose(wave[0], scorer.score(USERS[0], cand_ids), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(wave[1], scorer.score_many([USERS[1]], cand_ids)[0],
                               rtol=1e-6, atol=1e-7)
    scorer._wave = None  # leave the server's own wave to its batcher


def test_http_round_trip_and_metrics(servers):
    _, tserver = servers
    tserver.start()
    try:
        base = f"http://localhost:{tserver.port}"
        with urllib.request.urlopen(f"{base}/getrecforyou?id=14887&size=32&model=din",
                                    timeout=30) as r:
            assert r.status == 200
            assert r.headers["Access-Control-Allow-Origin"] == "*"
            assert len(json.loads(r.read())) == 32
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            snap = json.loads(r.read())
        assert snap["batchers"]["din"]["waves"] >= 1
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/index.html", timeout=30)
        assert e.value.code == 404
    finally:
        tserver.stop()


def test_cuda_default_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        TServer(TDataManager())


@pytest.mark.parametrize("uid", ["1", "2", "14887", "999", "abc", ""])
def test_ab_buckets_match_jax(uid):
    from sparrowrecsys_torch.serving.ab import get_config_by_user_id as tab
    from sparrowrecsys_tpu.serving.ab import get_config_by_user_id as jab

    assert tab(uid) == jab(uid)


def test_ab_test_routes_rec_for_you_by_user_bucket(servers):
    """With the A/B router on, `?model=` is ignored and each user's bucket
    picks the ranker; NeuralCF is not ported, so its bucket ("nerualcf")
    leaves the candidate order, as the JAX server does without a NeuralCF
    scorer."""
    from sparrowrecsys_torch.serving.ab import get_config_by_user_id

    jserver, tserver = servers
    users = sorted(tserver.dm.users)
    nerualcf = next(u for u in users if get_config_by_user_id(str(u)) == "nerualcf")
    emb = next(u for u in USERS if get_config_by_user_id(str(u)) == "emb")
    for s in servers:
        s.ab_test = True
    try:
        routed = {u: _get(tserver, "/getrecforyou", id=u, size=40, model="din")
                  for u in (nerualcf, emb)}
        ref = _get(jserver, "/getrecforyou", id=nerualcf, size=40, model="din")
    finally:
        for s in servers:
            s.ab_test = False
    assert routed[nerualcf] == ref
    assert routed[nerualcf] == _get(tserver, "/getrecforyou", id=nerualcf, size=40, model="x")
    assert routed[emb] == _get(tserver, "/getrecforyou", id=emb, size=40, model="emb")


def test_hot_reload_swaps_only_complete_readable_versions(tmp_path, servers):
    import shutil

    import flax.serialization

    from sparrowrecsys_torch.serving.rankers import ModelVersionWatcher
    from sparrowrecsys_torch.training.checkpoint import load_latest

    _, tserver = servers
    mdir = tmp_path / "din"
    shutil.copytree(f"{DATA}/modeldata/din/001", mdir / "001")
    scorer = TScorer.from_checkpoint(torch_build("din"), str(mdir),
                                     tserver.rec_for_you.scorers["din"].assembler, device="cpu")
    watcher = ModelVersionWatcher({"din": scorer}, poll_s=60)
    cand_ids = [m.movie_id for m in tserver.dm.get_movies(20, "rating")]
    before = scorer.score(USERS[0], cand_ids)

    tree, _, _ = load_latest(str(mdir))
    (mdir / "002").mkdir()                               # params but no meta.json yet
    tree["out"]["bias"] = tree["out"]["bias"] + 1.0
    (mdir / "002" / "params.msgpack").write_bytes(flax.serialization.to_bytes(tree))
    assert watcher.poll_once() == {}
    (mdir / "003").mkdir()                               # complete but corrupt
    (mdir / "003" / "params.msgpack").write_bytes(b"\xc1")
    (mdir / "003" / "meta.json").write_text("{}")
    assert watcher.poll_once() == {} and scorer.version == 1
    shutil.rmtree(mdir / "003")
    (mdir / "002" / "meta.json").write_text("{}")
    assert watcher.poll_once() == {"din": 2} and watcher.versions() == {"din": 2}
    after = scorer.score(USERS[0], cand_ids)
    assert np.all(after > before)                        # the output bias rose by 1

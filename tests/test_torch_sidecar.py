"""The TF-Serving sidecar (`sparrowrecsys_torch/serving/sidecar.py`) and its
REST client (`serving/rankers.py::RestScorer`) against the JAX package's,
on the CPU: the scores that come back over HTTP, the 400 and 404 bodies,
`map_post`'s None rules, and hot reload of a new export."""

import json
import os
import shutil
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from sparrowrecsys_torch.models import build_model
from sparrowrecsys_torch.serving.assembler import FeatureAssembler
from sparrowrecsys_torch.serving.catalog import DataManager
from sparrowrecsys_torch.serving.feature_store import FeatureStore
from sparrowrecsys_torch.serving.rankers import ModelScorer, RestScorer
from sparrowrecsys_torch.serving.sidecar import ScoringSidecar
from sparrowrecsys_torch.training import checkpoint
from sparrowrecsys_tpu.models import build_model as jax_build
from sparrowrecsys_tpu.serving.assembler import FeatureAssembler as JAssembler
from sparrowrecsys_tpu.serving.catalog import DataManager as JDataManager
from sparrowrecsys_tpu.serving.feature_store import FeatureStore as JStore
from sparrowrecsys_tpu.serving.rankers import ModelScorer as JScorer
from sparrowrecsys_tpu.serving.rankers import RestScorer as JRestScorer
from sparrowrecsys_tpu.serving.sidecar import ScoringSidecar as JSidecar

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")
USERS = (14887, 11888, 2, 25878)
#: The exports' float32 logit noise (1e-4 with raw numerics) times the
#: sigmoid's slope of 1/4, as the serving tests hold the two scorers.
SCORE_TOL = 2.5e-5


def _files():
    return (f"{DATA}/movies.csv", f"{DATA}/links.csv", f"{DATA}/ratings.csv", None, None)


@pytest.fixture(scope="module")
def sidecars():
    """(port sidecar, JAX sidecar, candidate ids), both over DeepFM's
    shipped export."""
    dm = DataManager().load_data(*_files())
    jdm = JDataManager().load_data(*_files())
    scorer = ModelScorer.from_checkpoint(
        build_model("deepfm"), f"{DATA}/modeldata/deepfm",
        FeatureAssembler(FeatureStore.load(f"{DATA}/feature_store.json"), dm), device="cpu")
    jscorer = JScorer.from_checkpoint(
        jax_build("deepfm"), f"{DATA}/modeldata/deepfm",
        assembler=JAssembler(JStore.load(f"{DATA}/feature_store.json"), jdm))
    port, jax_side = ScoringSidecar(scorer, port=0, poll_s=0), JSidecar(jscorer, port=0, poll_s=0)
    port.start()
    jax_side.start()
    cands = [m.movie_id for m in dm.get_movies(800, "rating")]
    yield port, jax_side, cands
    port.stop()
    jax_side.stop()


def _endpoint(sidecar, name="recmodel"):
    return f"http://localhost:{sidecar.port}/v1/models/{name}:predict"


def _post(url, body: bytes):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_rest_scores_are_the_in_process_scores_bit_for_bit(sidecars):
    port, _, cands = sidecars
    rest = RestScorer(_endpoint(port))
    for user in USERS:
        want = port.scorer.score(user, cands)
        got = rest.score(user, cands)
        assert got.dtype == np.float32 and got.shape == (len(cands),)
        np.testing.assert_array_equal(got, want)


def test_instances_of_several_users_are_grouped_by_user(sidecars):
    port, _, cands = sidecars
    rng = np.random.default_rng(0)
    users = rng.choice(USERS, 300)
    movies = rng.choice(cands, 300)
    body = json.dumps({"instances": [{"userId": int(u), "movieId": int(m)}
                                     for u, m in zip(users, movies)]}).encode()
    status, out = _post(_endpoint(port), body)
    assert status == 200
    got = np.array([p[0] for p in json.loads(out)["predictions"]], np.float32)
    for u in USERS:
        sel = users == u
        np.testing.assert_array_equal(got[sel], port.scorer.score(int(u), movies[sel].tolist()))


def test_scores_match_the_jax_sidecar(sidecars):
    port, jax_side, cands = sidecars
    for user in USERS[:2]:
        got = RestScorer(_endpoint(port)).score(user, cands)
        want = JRestScorer(_endpoint(jax_side)).score(user, cands)
        np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_TOL)


@pytest.mark.parametrize("body", [b"{not json", b'{"instances": [1, 2]}',
                                  b'{"instances": [{"userId": "x", "movieId": 1}]}'])
def test_a_malformed_body_gets_the_400_json_error_jax_gives(sidecars, body):
    port, jax_side, _ = sidecars
    got, want = _post(_endpoint(port), body), _post(_endpoint(jax_side), body)
    assert got[0] == want[0] == 400
    assert json.loads(got[1]) == json.loads(want[1])
    assert set(json.loads(got[1])) == {"error"}


def test_another_path_gets_404_and_no_instances_no_predictions(sidecars):
    port, jax_side, _ = sidecars
    for side in (port, jax_side):
        assert _post(_endpoint(side, "other"), b"{}")[0] == 404
        status, out = _post(_endpoint(side), b'{"instances": []}')
        assert status == 200 and json.loads(out) == {"predictions": []}


def test_map_post_none_rules_as_jax(sidecars):
    port, jax_side, _ = sidecars
    body = json.dumps({"instances": [{"userId": 2, "movieId": 1}]})
    for client in (RestScorer(_endpoint(port)), JRestScorer(_endpoint(port))):
        assert client.map_post({}) is None
        assert client.map_post(None) is None
        out = client.map_post({"a": body, "b": body})
        assert set(out) == {"a", "b"}
        assert json.loads(out["a"])["predictions"] == json.loads(out["b"])["predictions"]
        # One failing request (a 400) fails the whole batch.
        assert client.map_post({"a": body, "bad": "{not json"}) is None
    for cls in (RestScorer, JRestScorer):
        assert cls(_endpoint(port, "other")).map_post({"a": body}) is None


def test_a_new_export_is_served_within_two_polls(sidecars, tmp_path):
    port, _, cands = sidecars
    model_dir = str(tmp_path / "deepfm")
    shutil.copytree(f"{DATA}/modeldata/deepfm", model_dir)
    asm = port.scorer.assembler
    scorer = ModelScorer.from_checkpoint(build_model("deepfm"), model_dir, asm, device="cpu")
    side = ScoringSidecar(scorer, port=0, poll_s=0.2)
    side.start()
    try:
        old = scorer.version
        params = {k: v * 1.5 for k, v in scorer.model.state_dict().items()}
        t0 = time.perf_counter()
        checkpoint.save(checkpoint.params_to_flax(params, scorer.model), model_dir)
        while scorer.version == old and time.perf_counter() - t0 < 5:
            time.sleep(0.01)
        waited = time.perf_counter() - t0
        assert scorer.version == old + 1
        # Two polls of 0.2 s, and the slack of a loaded test machine.
        assert waited < 2 * 0.2 + 1.0, waited
        fresh = ModelScorer.from_checkpoint(build_model("deepfm"), model_dir, asm, device="cpu")
        np.testing.assert_array_equal(RestScorer(_endpoint(side)).score(USERS[0], cands),
                                      fresh.score(USERS[0], cands))
    finally:
        side.stop()

"""The nearline stream (`sparrowrecsys_torch/nearline/stream.py`) and its way
into the live ranker, against the JAX package on the CPU.

Each case of tests/test_nearline.py runs on both packages' streams with
the same expectations, and one file fed to both streams gives the same
sink output. The assembler's real-time history shift gives JAX's user
rows for the same catalog state, and its movie-block cache is rebuilt
after a store write and after a catalog `add_rating`. Last, a rating
appended to a file the stream watches reaches the next DIN ranking of
the port's server.
"""

import os
import time

import numpy as np
import pytest
import torch

from sparrowrecsys_torch.config import ServingConfig
from sparrowrecsys_torch.models import build_model
from sparrowrecsys_torch.nearline import stream as tstream
from sparrowrecsys_torch.serving import catalog as tcatalog
from sparrowrecsys_torch.serving.assembler import FeatureAssembler
from sparrowrecsys_torch.serving.feature_store import FeatureStore
from sparrowrecsys_torch.serving.rankers import ModelScorer
from sparrowrecsys_torch.serving.server import RecSysServer
from sparrowrecsys_tpu.nearline import stream as jstream
from sparrowrecsys_tpu.serving import catalog as jcatalog
from sparrowrecsys_tpu.serving.assembler import FeatureAssembler as JAssembler
from sparrowrecsys_tpu.serving.feature_store import FeatureStore as JStore

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")
PACKAGES = {"port": (tstream, tcatalog), "jax": (jstream, jcatalog)}


@pytest.fixture(params=list(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def test_tail_source_emits_only_new_rows(tmp_path, pkg):
    stream, _ = pkg
    path = tmp_path / "ratings.csv"
    path.write_text("userId,movieId,rating,timestamp\n1,10,4.0,100\n")
    src = stream.FileWatchSource(str(path), interval=0.01)
    assert src.poll() == []
    with open(path, "a") as f:
        f.write("2,20,3.0,200\nbad,row\n3,30,5.0,300\n")
    assert [(e.user_id, e.movie_id) for e in src.poll()] == [(2, 20), (3, 30)]
    assert src.poll() == []


def test_from_start_replays_existing(tmp_path, pkg):
    stream, _ = pkg
    path = tmp_path / "ratings.csv"
    path.write_text("userId,movieId,rating,timestamp\n1,10,4.0,100\n")
    src = stream.FileWatchSource(str(path), interval=0.01, from_start=True)
    assert [(e.user_id, e.movie_id) for e in src.poll()] == [(1, 10)]


def test_window_keeps_latest_per_user(tmp_path, pkg):
    stream, _ = pkg
    path = tmp_path / "ratings.csv"
    path.write_text("userId,movieId,rating,timestamp\n")
    out = []
    s = stream.LatestRatingStream(
        stream.FileWatchSource(str(path), interval=0.01, from_start=True),
        window_seconds=0.1, sink=out.append)
    with open(path, "a") as f:
        f.write("1,10,4.0,100\n1,11,3.0,300\n1,12,5.0,200\n2,20,2.0,50\n")
    s.run_for(0.5)
    assert {e.user_id: e.movie_id for e in out} == {1: 11, 2: 20}


def test_attach_to_store_updates_user_features(tmp_path, pkg):
    stream, catalog = pkg
    dm = catalog.DataManager()
    dm.users[7] = catalog.User(7)
    path = tmp_path / "ratings.csv"
    path.write_text("")
    s = stream.LatestRatingStream(
        stream.FileWatchSource(str(path), interval=0.01, from_start=True),
        window_seconds=0.1, sink=lambda e: None)
    stream.attach_to_store(s, dm)
    with open(path, "a") as f:
        f.write("7,42,5.0,999\n")
    s.run_for(0.4)
    assert dm.users[7].user_features == {"latestMovieId": "42", "latestMovieRating": "5.0"}


def test_crlf_file_offsets_stay_exact(tmp_path, pkg):
    stream, _ = pkg
    path = tmp_path / "ratings.csv"
    path.write_bytes(b"userId,movieId,rating,timestamp\r\n")
    src = stream.FileWatchSource(str(path), interval=0.01)
    assert src.poll() == []
    with open(path, "ab") as f:
        for i in range(1, 21):
            f.write(f"{i},{i * 10},4.0,{i * 100}\r\n".encode())
    assert [(e.user_id, e.movie_id) for e in src.poll()] == [(i, i * 10) for i in range(1, 21)]
    assert src.poll() == []


def test_truncation_resets_offset(tmp_path, pkg):
    stream, _ = pkg
    path = tmp_path / "ratings.csv"
    path.write_text("userId,movieId,rating,timestamp\n1,10,4.0,100\n")
    src = stream.FileWatchSource(str(path), interval=0.01)
    assert src.poll() == []
    path.write_text("2,20,3.0,200\n")
    assert [(e.user_id, e.movie_id) for e in src.poll()] == [(2, 20)]


def test_attach_creates_first_seen_users(tmp_path, pkg):
    stream, catalog = pkg
    dm = catalog.DataManager()
    path = tmp_path / "r.csv"
    path.write_text("")
    s = stream.LatestRatingStream(
        stream.FileWatchSource(str(path), interval=0.01, from_start=True),
        window_seconds=0.1, sink=lambda e: None)
    stream.attach_to_store(s, dm)
    with open(path, "a") as f:
        f.write("99,7,5.0,1\n")
    s.run_for(0.3)
    assert isinstance(dm.users[99], catalog.User)
    assert dm.users[99].user_features["latestMovieId"] == "7"


def test_one_file_gives_both_streams_the_same_sink_output(tmp_path):
    """CRLF and LF rows, a header, malformed rows, a partial last row and
    several events per user: both streams emit the same events."""
    rng = np.random.default_rng(11)
    lines = [b"userId,movieId,rating,timestamp\r\n"]
    for i in range(400):
        end = b"\r\n" if i % 3 else b"\n"
        lines.append(f"{rng.integers(1, 40)},{rng.integers(1, 900)},"
                     f"{rng.integers(1, 11) * 0.5},{rng.integers(0, 10_000)}".encode() + end)
        if i % 57 == 0:
            lines.append(b"x,y,z,w\n")
    path = tmp_path / "ratings.csv"
    path.write_bytes(b"".join(lines) + b"5,6,4.0")
    outputs = []
    for stream in (tstream, jstream):
        out = []
        s = stream.LatestRatingStream(
            stream.FileWatchSource(str(path), interval=0.01, from_start=True),
            window_seconds=0.05, sink=out.append)
        s.run_for(0.2)
        outputs.append([(e.user_id, e.movie_id, e.rating, e.timestamp) for e in out])
    assert len(outputs[0]) == 39
    assert outputs[0] == outputs[1]


def test_stream_main_tails_the_named_file(tmp_path, capsys):
    path = tmp_path / "ratings.csv"
    path.write_text("userId,movieId,rating,timestamp\n3,30,4.5,10\n")
    tstream.main(["--ratings", str(path), "--from-start", "--duration", "0.2"])
    out = capsys.readouterr().out
    assert f"watching {path}" in out and "user:3\tlatest movie:30" in out


# ---- the assembler: real-time shift and the movie-block cache --------------

HISTORY = {"userRatedMovie1": "10", "userRatedMovie2": "20", "userRatedMovie3": "30",
           "userRatedMovie4": "", "userRatedMovie5": "", "userGenre1": "Drama",
           "userRatingCount": "3", "userAvgRating": "4.1"}

REALTIME = {
    "positive": {"latestMovieId": "42", "latestMovieRating": "4.5"},
    "negative": {"latestMovieId": "42", "latestMovieRating": "2.0"},
    "already_first": {"latestMovieId": "10", "latestMovieRating": "5.0"},
    "no_rating": {"latestMovieId": "42"},
    "no_features": None,
    "zero_movie": {"latestMovieId": "0", "latestMovieRating": "5.0"},
}


@pytest.mark.parametrize("case", list(REALTIME))
def test_realtime_shift_matches_jax(case):
    rows = []
    for store_cls, catalog, asm_cls in ((FeatureStore, tcatalog, FeatureAssembler),
                                        (JStore, jcatalog, JAssembler)):
        store = store_cls()
        store.hset("uf:7", HISTORY)
        dm = catalog.DataManager()
        dm.users[7] = catalog.User(7)
        dm.users[7].user_features = REALTIME[case]
        rows.append(asm_cls(store, dm).user_row(7))
    assert rows[0] == rows[1]
    shifted = rows[0]["userRatedMovie1"] == 42
    assert shifted == (case in ("positive", "no_rating"))
    if shifted:
        assert [rows[0][f"userRatedMovie{k}"] for k in range(1, 6)] == [42, 10, 20, 30, 0]


def _movie_catalogs():
    """A port and a JAX catalog of three movies; movie 3 has no `mf:` hash
    and falls back to the catalog."""
    dms = []
    for catalog in (tcatalog, jcatalog):
        dm = catalog.DataManager()
        for mid in (1, 2, 3):
            dm.movies[mid] = catalog.Movie(mid, f"M{mid}", 1990 + mid, genres=["Drama"])
            dm.movies[mid].add_rating(catalog.Rating(mid, 1, 3.0, 1))
        dms.append(dm)
    return dms


def test_movie_block_rebuilds_after_a_store_write_and_add_rating():
    blocks = []
    for (store_cls, catalog, asm_cls), dm in zip(
            ((FeatureStore, tcatalog, FeatureAssembler), (JStore, jcatalog, JAssembler)),
            _movie_catalogs()):
        store = store_cls()
        store.hset("mf:1", {"movieGenre1": "Action", "releaseYear": "1995",
                            "movieRatingCount": "7", "movieAvgRating": "3.5"})
        asm = asm_cls(store, dm)
        seen = [asm.movie_block([1, 2, 3])]
        store.hset("mf:1", {"movieGenre1": "Comedy", "releaseYear": "1995",
                            "movieRatingCount": "8", "movieAvgRating": "3.75"})
        seen.append(asm.movie_block([1, 2, 3]))
        dm.movies[3].add_rating(catalog.Rating(3, 2, 5.0, 2))
        seen.append(asm.movie_block([1, 2, 3]))
        blocks.append(seen)
    (before, written, rated), jax_blocks = blocks
    # MOVIE_FLOAT_COLS: releaseYear, movieRatingCount, movieAvgRating, ...
    assert written[1][0, 1] == 8.0 and written[0][0, 0] == 6  # Comedy
    assert before[1][0, 1] == 7.0
    assert rated[1][2, 1] == 2.0 and rated[1][2, 2] == 4.0
    assert written[1][2, 1] == 1.0
    for got, want in zip(blocks[0], jax_blocks):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_a_streamed_rating_reaches_the_next_din_ranking(tmp_path):
    """The port's server ranks with DIN; a positive rating appended to the
    watched file puts its movie first in the user's history, and the
    user's DIN scores change."""
    store = FeatureStore.load(os.path.join(DATA, "feature_store.json"))
    dm = tcatalog.DataManager().load_data(
        f"{DATA}/movies.csv", f"{DATA}/links.csv", f"{DATA}/ratings.csv",
        f"{DATA}/modeldata/item2vecEmb.csv", f"{DATA}/modeldata/userEmb.csv")
    asm = FeatureAssembler(store, dm)
    scorer = ModelScorer.from_checkpoint(build_model("din"), f"{DATA}/modeldata/din", asm,
                                         device="cpu")
    server = RecSysServer(dm, ServingConfig(port=0, model_batch=2, model_poll_s=0),
                          scorers={"din": scorer}, device="cpu")
    user = 14887
    first = asm.user_row(user)["userRatedMovie1"]
    movie = next(m for m in (1, 2, 3) if m != first)
    cands = [m.movie_id for m in dm.get_movies(50, "rating")]
    before = scorer.score(user, cands)

    path = tmp_path / "ratings.csv"
    path.write_text("userId,movieId,rating,timestamp\n")
    s = tstream.LatestRatingStream(tstream.FileWatchSource(str(path), interval=0.02),
                                   window_seconds=0.1, sink=lambda e: None)
    tstream.attach_to_store(s, dm)
    s.start()
    try:
        time.sleep(0.1)  # the first poll skips what the file holds
        with open(path, "a") as f:
            f.write(f"{user},{movie},5.0,1700000000\n")
        deadline = time.time() + 10
        while asm.user_row(user)["userRatedMovie1"] != movie and time.time() < deadline:
            time.sleep(0.02)
    finally:
        s.stop()
    row = asm.user_row(user)
    assert row["userRatedMovie1"] == movie and row["userRatedMovie2"] == first
    assert not np.array_equal(scorer.score(user, cands), before)
    status, _, body = server.handle("/getrecforyou", lambda k, d="": {
        "id": str(user), "size": "8", "model": "din"}.get(k, d))
    assert status == 200 and body.startswith(b"[")

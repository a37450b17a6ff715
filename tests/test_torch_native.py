"""The port's C++ CSV loader (`sparrowrecsys_torch/native/`) against the
JAX package's (`sparrowrecsys_tpu/native/`): the package's copy of the
source is the repo root's byte for byte, its build reads every shipped
file bit-equal to the JAX package's library, each case of
`tests/test_native.py` holds for it with that test's bound, and the port's
callers (`load_samples`, `DataManager`, `data.run --native`) read through
it. The host C++ compiler builds it where the tests run."""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from sparrowrecsys_torch import native
from sparrowrecsys_torch.data.dataset import load_samples, load_samples_csv
from sparrowrecsys_torch.data.schema import SAMPLE_COLUMNS
from sparrowrecsys_torch.embedding.artifacts import load_embeddings_csv, write_embeddings_csv
from sparrowrecsys_torch.native import loader
from sparrowrecsys_tpu import native as jnative
from sparrowrecsys_tpu.data.dataset import load_samples_csv as jax_load_samples_csv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")
EMBEDDING_FILES = sorted(glob.glob(os.path.join(DATA, "modeldata", "*Emb*.csv")))

#: Rows of tests/test_native.py's sample cases.
GOOD = "1,2,3.5,1000,1,1995,Action,,,10,3.50,0.5,0,0,0,0,0,5,1995,0.1,3.2,0.4,Comedy,,,,"
SHORT = "9,9,1.0"


@pytest.fixture(autouse=True)
def _built():
    assert native.native_available()


def _same_table(a, b):
    """Equal columns in value and dtype (the two parses add them in
    different orders, in both packages)."""
    assert sorted(a.columns) == sorted(b.columns)
    for k in b.columns:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k


def _same_ratings(a, b):
    for f in ("user_ids", "movie_ids", "ratings", "timestamps"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_source_is_the_repo_roots_byte_for_byte():
    with open(os.path.join(REPO, "native", "csv_loader.cc"), "rb") as f:
        root = f.read()
    with open(loader.SOURCE, "rb") as f:
        assert f.read() == root


def test_build_is_cached_by_source_and_flags_and_leaves_out_march_native():
    assert os.path.exists(loader.library_path())
    assert os.path.dirname(loader.library_path()) == loader.BUILD_DIR
    assert not any(f.startswith("-march") for f in loader.CXX_FLAGS)
    assert {"-O3", "-fPIC", "-std=c++17", "-shared"} <= set(loader.CXX_FLAGS)


def test_processes_building_at_once_all_load_the_library(tmp_path):
    """Three processes build into one empty directory together; each writes
    through a temporary file and os.replace, and each parses."""
    code = (
        "import sys\n"
        "from sparrowrecsys_torch.native import loader\n"
        f"loader.BUILD_DIR = {str(tmp_path)!r}\n"
        f"r = loader.load_ratings_native({os.path.join(DATA, 'ratings.csv')!r})\n"
        "print(len(r), loader.counts()['native'])\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        n, used = out.split()
        assert int(n) > 0 and int(used) == 1
    assert [os.path.basename(p) for p in glob.glob(str(tmp_path / "*"))] == \
        [os.path.basename(loader.library_path())]


# ---- tests/test_native.py's cases, against the port and JAX alike --------


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def test_ratings_garbage_rows_skipped(tmp_path):
    path = _write(tmp_path, "ratings.csv",
                  "userId,movieId,rating,timestamp\n1,10,4.5,100\ngarbage,row\n"
                  "2,20,3.0,200\n3,30,5,300\n")
    got = native.load_ratings_native(path)
    assert got.user_ids.tolist() == [1, 2, 3]
    assert got.ratings.tolist() == [4.5, 3.0, 5.0]
    assert got.timestamps.tolist() == [100, 200, 300]
    _same_ratings(got, jnative.load_ratings_native(path))


@pytest.mark.parametrize("text, want", [
    # rows wider or narrower than the first row are skipped
    ("1:0.5 0.5\n2:1.0 2.0 3.0\n3:0.25 0.75\n", {1: [0.5, 0.5], 3: [0.25, 0.75]}),
    # exponent floats
    ("7:1.5e-3 -2E2 3e+1\n", {7: [0.0015, -200.0, 30.0]}),
])
def test_embeddings_widths_and_exponents(tmp_path, text, want):
    path = _write(tmp_path, "emb.csv", text)
    got, ref = native.load_embeddings_native(path), jnative.load_embeddings_native(path)
    assert list(got) == list(ref) == list(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6)
        np.testing.assert_array_equal(got[k], ref[k])


def test_embeddings_against_the_python_parse(tmp_path):
    """tests/test_native.py's bound: rtol 1e-6 against `load_embeddings_csv`."""
    path = str(tmp_path / "emb.csv")
    vecs = np.random.default_rng(1).normal(size=(37, 10)).astype(np.float32)
    write_embeddings_csv(path, np.arange(100, 137), vecs)
    got, py = native.load_embeddings_native(path), load_embeddings_csv(path)
    assert set(got) == set(py)
    for k in got:
        np.testing.assert_allclose(got[k], py[k], rtol=1e-6)


@pytest.mark.parametrize("parse", ["native", "python"])
def test_samples_short_rows_skipped(tmp_path, parse):
    """A row missing sample fields is skipped by both parses; empty genre
    and history fields read -1 and 0."""
    path = _write(tmp_path, "s.csv", ",".join(SAMPLE_COLUMNS) + f"\n{GOOD}\n{SHORT}\n")
    t = native.load_samples_native(path) if parse == "native" else load_samples_csv(path)
    assert len(t) == 1
    assert t["movieId"][0] == 1 and t["userId"][0] == 2
    assert t["movieGenre1"][0] >= 0 and t["movieGenre2"][0] == -1
    assert t["userRatedMovie1"][0] == 0
    _same_table(t, jnative.load_samples_native(path))


def test_samples_noncanonical_numerics_agree(tmp_path):
    """Extra trailing header columns, a row stopping at the last sample
    column, trailing junk ('12abc'), 'nan', 'inf' and '1e400' (all 0), and a
    short row: the native and the Python parse give one table, JAX's."""
    header = ",".join(list(SAMPLE_COLUMNS) + ["extraA", "extraB"])
    full = GOOD + ",x,y"
    stops = "3,4,4.0,1200,1,1990,Drama,,,7,4.00,0.2,0,0,0,0,0,3,1990,0.2,4.0,0.3,Drama,,,,"
    junk = ("12abc,6,nan,1400,1,inf,Action,,,1e400,3.00,0.1,0,0,0,0,0,2,1985,0.0,3.0,0.0,"
            "Action,,,,")
    path = _write(tmp_path, "s.csv", "\n".join([header, full, stops, junk, SHORT]) + "\n")
    got, py = native.load_samples_native(path), load_samples_csv(path)
    assert len(got) == len(py) == 3
    _same_table(got, py)
    _same_table(got, jnative.load_samples_native(path))
    assert got["movieId"][2] == 0 and got["rating"][2] == 0.0
    assert got["releaseYear"][2] == 0 and got["movieRatingCount"][2] == 0


# ---- the shipped files, bit-equal to the JAX package's library -------------


def test_golden_samples_bit_equal_to_jax_and_to_the_python_parse():
    path = os.path.join(DATA, "goldenTestSamples.csv")
    got = native.load_samples_native(path)
    assert len(got) == 22440
    _same_table(got, jnative.load_samples_native(path))
    _same_table(got, load_samples_csv(path))
    _same_table(got, jax_load_samples_csv(path))


def test_bundled_ratings_bit_equal_to_jax():
    from sparrowrecsys_torch.data.movielens import load_ratings

    path = os.path.join(DATA, "ratings.csv")
    got = native.load_ratings_native(path)
    _same_ratings(got, jnative.load_ratings_native(path))
    _same_ratings(got, load_ratings(path))


@pytest.mark.parametrize("path", EMBEDDING_FILES, ids=os.path.basename)
def test_shipped_embeddings_bit_equal_to_jax(path):
    got, ref = native.load_embeddings_native(path), jnative.load_embeddings_native(path)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], ref[k])


def test_all_nan_graph_embeddings_are_no_rows_natively_and_nan_rows_in_python():
    """The shipped itemGraphEmb.csv is all `nan`: the C++ parser rejects the
    tokens (0 rows, as JAX's native function), the Python parse keeps 624
    rows of NaN (as JAX's `load_embeddings_csv`)."""
    path = os.path.join(DATA, "modeldata", "itemGraphEmb.csv")
    assert native.load_embeddings_native(path) == {} == jnative.load_embeddings_native(path)
    py = load_embeddings_csv(path)
    assert len(py) == 624 and all(np.isnan(v).all() for v in py.values())


# ---- the counter and the fallback ------------------------------------------


def test_counts_record_the_native_parse():
    native.reset_counts()
    native.load_ratings_native(os.path.join(DATA, "ratings.csv"))
    native.load_embeddings_native(EMBEDDING_FILES[0])
    assert native.counts() == {"native": 2, "python": 0}
    native.reset_counts()
    assert native.counts() == {"native": 0, "python": 0}


def test_without_a_compiler_every_function_falls_back_and_counts_it(tmp_path, monkeypatch):
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert loader.compiler() is None and not native.native_available()
    native.reset_counts()
    ratings = native.load_ratings_native(os.path.join(DATA, "ratings.csv"))
    samples = native.load_samples_native(os.path.join(DATA, "goldenTestSamples.csv"))
    emb = native.load_embeddings_native(os.path.join(DATA, "modeldata", "itemGraphEmb.csv"))
    assert native.counts() == {"native": 0, "python": 3}
    _same_ratings(ratings, jnative.load_ratings_native(os.path.join(DATA, "ratings.csv")))
    assert len(samples) == 22440 and len(emb) == 624


def test_a_compiler_that_fails_raises_with_its_output(tmp_path, monkeypatch):
    fake = tmp_path / "c++"
    fake.write_text("#!/bin/sh\necho 'broken compiler' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="broken compiler"):
        native.load_ratings_native(os.path.join(DATA, "ratings.csv"))


# ---- the callers -------------------------------------------------------------


def test_load_samples_reads_through_the_native_loader():
    native.reset_counts()
    table = load_samples(os.path.join(DATA, "testSamples.csv"))
    assert native.counts() == {"native": 1, "python": 0}
    _same_table(table, load_samples_csv(os.path.join(DATA, "testSamples.csv")))


def test_data_manager_reads_ratings_natively_and_matches_jax(capsys):
    from sparrowrecsys_torch.serving.catalog import DataManager
    from sparrowrecsys_tpu.serving.catalog import DataManager as JaxDataManager

    files = [os.path.join(DATA, f) for f in ("movies.csv", "links.csv", "ratings.csv")]
    native.reset_counts()
    dm = DataManager().load_data(*files, None, None)
    assert native.counts() == {"native": 1, "python": 0}
    ref = JaxDataManager().load_data(*files, None, None)
    assert list(dm.movies) == list(ref.movies) and list(dm.users) == list(ref.users)
    for uid in list(ref.users)[:200]:
        assert [r.to_json() for r in dm.users[uid].ratings] == \
            [r.to_json() for r in ref.users[uid].ratings]
    for mid, m in ref.movies.items():
        assert dm.movies[mid].to_json() == m.to_json()


def test_data_run_native_writes_what_the_job_writes_without_it(tmp_path, capsys):
    from sparrowrecsys_torch.data import run

    outs = {}
    for flag in ((), ("--native",)):
        out = tmp_path / ("native" if flag else "python")
        native.reset_counts()
        run.main(["--data-root", DATA, "--out-dir", str(out), *flag])
        assert native.counts()["native"] == (1 if flag else 0)
        outs[bool(flag)] = {f: (out / f).read_bytes()
                            for f in ("trainingSamples.csv", "testSamples.csv")}
    assert outs[True] == outs[False]
    with open(os.path.join(DATA, "testSamples.csv"), "rb") as f:
        assert outs[True]["testSamples.csv"] == f.read()

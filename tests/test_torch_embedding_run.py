"""The rest of the candidate-generation plane in the port against the JAX
package on the CPU: the artifact writer (the same bytes), user embeddings
and LSH (bit for bit), the two command lines (`embedding.run` writing the
files the server's `emb` paths read, `models.als` printing an RMSE), the
recall twin's protocol (`leave_one_out_split`, `recall_at_k` and the
popularity figure equal to the reference's `recall.json`), and
`emb_quality`'s planted-structure score."""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparrowrecsys_torch.embedding.deepwalk as deepwalk
from sparrowrecsys_torch.data.movielens import load_ratings
from sparrowrecsys_torch.embedding.artifacts import load_embeddings_csv, write_embeddings_csv
from sparrowrecsys_torch.embedding.lsh import LSHIndex
from sparrowrecsys_torch.embedding.user_emb import generate_user_emb
from sparrowrecsys_torch.tools import emb_quality, recall_eval
from sparrowrecsys_tpu.embedding.artifacts import write_embeddings_csv as jax_write
from sparrowrecsys_tpu.embedding.lsh import LSHIndex as JaxLSH
from sparrowrecsys_tpu.embedding.user_emb import generate_user_emb as jax_user_emb

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "data")
#: recall.json's popularity recall@10 (the reference's figure).
POPULARITY_RECALL = 0.08982035928143713


@pytest.fixture(scope="module")
def ratings():
    return load_ratings(os.path.join(DATA, "ratings.csv"))


@pytest.fixture(scope="module")
def item_table():
    rng = np.random.default_rng(0)
    vocab = np.unique(rng.integers(1, 1001, 400))
    emb = rng.normal(size=(len(vocab), 10)).astype(np.float32)
    emb[3] = 0.0
    return vocab, emb


def test_writer_writes_the_jax_bytes(tmp_path, item_table):
    vocab, emb = item_table
    emb = emb.copy()
    emb[0, :3] = [1e-8, -0.0, 123456.78]  # exponent form, signed zero, large
    write_embeddings_csv(str(tmp_path / "port" / "e.csv"), vocab, emb)
    jax_write(str(tmp_path / "jax" / "e.csv"), vocab, jnp.asarray(emb))
    got = (tmp_path / "port" / "e.csv").read_bytes()
    assert got == (tmp_path / "jax" / "e.csv").read_bytes()
    back = load_embeddings_csv(str(tmp_path / "port" / "e.csv"))
    assert sorted(back) == vocab.tolist()
    np.testing.assert_array_equal(np.stack([back[int(v)] for v in vocab]), emb)


@pytest.mark.parametrize("mode", ["mean", "sum"])
def test_user_embeddings_bit_equal(ratings, item_table, mode):
    vocab, emb = item_table
    got = generate_user_emb(ratings, vocab, emb, mode)
    want = jax_user_emb(ratings, vocab, emb, mode)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        generate_user_emb(ratings, vocab, emb, "max")


def test_lsh_buckets_and_queries_bit_equal(item_table):
    vocab, emb = item_table
    got, want = LSHIndex(emb, vocab), JaxLSH(emb, vocab)
    np.testing.assert_array_equal(got.proj, want.proj)
    np.testing.assert_array_equal(got.buckets, want.buckets)
    for row in (0, 3, 17, len(vocab) - 1):
        assert got.query(emb[row], k=5) == want.query(emb[row], k=5)
    assert got.query(np.full(10, 1e6, np.float32)) == want.query(np.full(10, 1e6, np.float32))


def test_embedding_run_writes_what_the_server_reads(tmp_path, monkeypatch, capsys):
    """`embedding.run --cpu --graph-emb --user-emb --epochs 2` with its
    default output directory under a temporary data root (DeepWalk cut to
    2,000 walks here); the port's server then answers the `emb` paths
    from those files."""
    from sparrowrecsys_torch.embedding import run
    from sparrowrecsys_torch.serving.server import server_from_args

    for name in ("movies.csv", "links.csv", "ratings.csv"):
        shutil.copy(os.path.join(DATA, name), tmp_path / name)
    cut = deepwalk.DeepWalkConfig(sample_count=2000)
    monkeypatch.setattr(deepwalk, "DeepWalkConfig", lambda: cut)
    run.main(["--cpu", "--data-root", str(tmp_path), "--graph-emb", "--user-emb",
              "--epochs", "2"])
    out = capsys.readouterr().out
    assert "item2vec: 625 items x 10d on cpu" in out and "userEmb:" in out
    files = {n: load_embeddings_csv(str(tmp_path / "modeldata" / n))
             for n in ("item2vecEmb.csv", "itemGraphEmb.csv", "userEmb.csv")}
    assert len(files["item2vecEmb.csv"]) == 625
    assert 0 < len(files["itemGraphEmb.csv"]) <= 625
    assert len(files["userEmb.csv"]) > 1000
    assert all(v.shape == (10,) and np.isfinite(v).all()
               for f in files.values() for v in f.values())

    server = server_from_args(["--cpu", "--data-root", str(tmp_path)])
    user = next(iter(files["userEmb.csv"]))
    for path, params in (("/getsimilarmovie", {"movieId": 158, "size": 10, "model": "emb"}),
                         ("/getrecforyou", {"id": user, "size": 10, "model": "emb"})):
        status, _, body = server.handle(path, lambda k, d="", p=params: str(p.get(k, d)))
        movies = json.loads(body)
        assert status == 200 and len(movies) == 10, (path, body[:200])


def test_als_cli_prints_an_rmse(capsys):
    from sparrowrecsys_torch.models import als

    als.main(["--cpu"])
    out = capsys.readouterr().out
    rmse = float(out.split("Root-mean-square error = ")[1].split()[0])
    assert 0.5 < rmse < 3.0, out
    assert "users," in out and "items with recs" in out


def test_recall_protocol_and_popularity_equal_the_reference(ratings):
    import tools.recall_eval as jax_recall

    got = recall_eval.leave_one_out_split(ratings)
    want = jax_recall.leave_one_out_split(ratings)
    for name in ("user_ids", "movie_ids", "ratings", "timestamps"):
        np.testing.assert_array_equal(getattr(got[0], name), getattr(want[0], name))
    assert got[1] == want[1]
    assert got[2].keys() == want[2].keys()
    assert all(np.array_equal(got[2][u], want[2][u]) for u in got[2])
    train, test_pairs, seen = got
    pop = recall_eval.eval_popularity(train, test_pairs, seen, 10)
    assert pop == POPULARITY_RECALL
    assert pop == jax_recall.eval_popularity(train, test_pairs, seen, 10)
    rng = np.random.default_rng(0)
    rows = {int(u): rng.normal(size=recall_eval.N_ITEMS).astype(np.float32)
            for u, _ in test_pairs[::2]}
    for k in (1, 10, 50):
        assert (recall_eval.recall_at_k(rows, test_pairs, seen, k)
                == jax_recall.recall_at_k(rows, test_pairs, seen, k))


def test_recall_twin_learned_methods_on_the_cpu(ratings):
    """The two-tower retrieval (one epoch) and the CTR two-tower score every
    test user over the catalog."""
    train, test_pairs, seen = recall_eval.leave_one_out_split(ratings)
    rt = recall_eval.eval_two_tower_retrieval(train, test_pairs, seen, 10, 1, device="cpu")
    ctr = recall_eval.eval_two_tower_ctr(train, test_pairs, seen, 10, 1, device="cpu")
    for r in (rt, ctr):
        assert 0.0 <= r <= 1.0
    assert rt > 10 / recall_eval.N_ITEMS  # logQ towers with the popularity restore


def test_emb_quality_matches_the_jax_tool():
    import tools.emb_scale as jax_scale
    from sparrowrecsys_torch.data.synthetic import SyntheticSpec

    spec = SyntheticSpec(300, 120, 20_000)
    vf = emb_quality.planted_item_latents(spec)
    np.testing.assert_array_equal(vf, jax_scale.planted_item_latents(spec))
    rng = np.random.default_rng(1)
    vocab = np.arange(1, 121)
    emb = (vf @ rng.normal(size=(8, 10)) + 0.1 * rng.normal(size=(120, 10))).astype(np.float32)
    got = emb_quality.neighbor_quality(vocab, emb, vf, n_queries=64, device="cpu")
    assert got == jax_scale.neighbor_quality(vocab, emb, vf, n_queries=64)
    assert got["neighbor_planted_cos"] > got["random_pair_cos"] + 0.3


def test_emb_quality_main_runs_the_plane(capsys):
    out = emb_quality.main(["--cpu", "--events", "20000", "--users", "300", "--movies", "120",
                            "--epochs", "1", "--batch-size", "1024", "--walks", "500"])
    assert out["vocab"] <= 120 and out["n_edges"] > 0 and out["sgns_pairs_per_sec"] > 0
    printed = capsys.readouterr().out
    assert "item2vec quality" in printed and "deepwalk quality" in printed

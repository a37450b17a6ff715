"""The port's ALS (`sparrowrecsys_torch/models/als.py`) against the JAX
package's on the CPU, on tests/test_als.py's planted block ratings.

Both packages start from JAX's initial factors (als.py:209-214, drawn
here and injected into the port). Tolerances: one side's solve, and the
factors after 5 iterations at rank 4, within 1e-4 of the factor matrix's
largest magnitude (float32 sums and LU solves in another order); at rank
10 the predictions within 1e-4 of their largest magnitude and the factors
within 2e-4 of theirs (rank 10 on rank-2 data leaves ill-conditioned
systems, which part the factors more than the predictions); on the
bundled ratings' 80/20 split, the gates `chip_smoke.py` holds the card
to (its ALS_* constants; run with -s to print the gaps); the chunked sums
equal the direct ones to 1e-4 of scale; `cross_validate`'s RMSE within
1e-4; the recommendations rank the same ids as JAX's where the scores
are untied."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparrowrecsys_torch.models.als as T
import sparrowrecsys_tpu.models.als as J
from sparrowrecsys_torch.data.movielens import Ratings as TRatings
from tests.test_als import block_ratings

TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_init(ratings, config):
    n_u = len(np.unique(ratings.user_ids))
    n_i = len(np.unique(ratings.movie_ids))
    ku, ki = jax.random.split(jax.random.PRNGKey(config.seed))
    k = config.rank
    uf = jax.random.uniform(ku, (n_u, k), jnp.float32, 0.0, 1.0) / np.sqrt(k)
    vf = jax.random.uniform(ki, (n_i, k), jnp.float32, 0.0, 1.0) / np.sqrt(k)
    return np.asarray(uf), np.asarray(vf)


@pytest.fixture(scope="module")
def split():
    ratings = block_ratings()
    rng = np.random.default_rng(1)
    mask = rng.random(len(ratings)) < 0.8
    pick = lambda sel: TRatings(ratings.user_ids[sel], ratings.movie_ids[sel],  # noqa: E731
                                ratings.ratings[sel], ratings.timestamps[sel])
    return pick(mask), pick(~mask)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def test_one_side_solve_matches_jax(split):
    train, _ = split
    _, u_idx = np.unique(train.user_ids, return_inverse=True)
    _, i_idx = np.unique(train.movie_ids, return_inverse=True)
    n_u = int(u_idx.max()) + 1
    _, vf = jax_init(train, J.ALSConfig(rank=4))
    want = J._solve_side(jnp.asarray(vf), jnp.asarray(u_idx), jnp.asarray(i_idx),
                         jnp.asarray(train.ratings), 0.01, n_u + 3)  # 3 empty rows
    got = T._solve_side(torch.tensor(vf), torch.from_numpy(u_idx), torch.from_numpy(i_idx),
                        torch.from_numpy(train.ratings), 0.01, n_u + 3)
    assert np.all(np.asarray(want)[n_u:] == 0) and torch.all(got[n_u:] == 0)  # empty rows: zero
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rank", [4, 10])
def test_train_als_from_jax_init_matches_jax(split, rank):
    train, test = split
    cfg = T.ALSConfig(rank=rank)
    want = J.train_als(train, J.ALSConfig(rank=rank))
    got = T.train_als(train, cfg, device="cpu", init=jax_init(train, cfg))
    np.testing.assert_array_equal(got.user_ids, want.user_ids)
    np.testing.assert_array_equal(got.item_ids, want.item_ids)
    factor_tol = TOL if rank == 4 else 2 * TOL
    _close(got.user_factors, want.user_factors, factor_tol)
    _close(got.item_factors, want.item_factors, factor_tol)
    _close(got.predict(train.user_ids, train.movie_ids),
           want.predict(train.user_ids, train.movie_ids))
    assert abs(got.rmse(test) - want.rmse(test)) <= TOL
    if rank == 4:
        assert got.rmse(test) < 0.6


def test_bundled_split_within_the_card_gates():
    """The shipped config on `main`'s split of the bundled ratings: the
    port against JAX, both float32 on the CPU, printed and held to the
    gates chip_smoke.py holds the card against the CPU to."""
    import chip_smoke
    from sparrowrecsys_torch.data.movielens import load_ratings

    ratings = load_ratings(os.path.join(REPO, "data", "ratings.csv"))
    train, test = T.split_80_20(ratings)
    cfg = T.ALSConfig()
    want = J.train_als(train)
    got = T.train_als(train, cfg, device="cpu", init=jax_init(train, cfg))
    gaps = {"user": chip_smoke.rel_gap(got.user_factors, want.user_factors),
            "item": chip_smoke.rel_gap(got.item_factors, want.item_factors),
            "test_predictions": chip_smoke.rel_gap(got.transform_drop(test)[0],
                                                   want.transform_drop(test)[0]),
            "rmse": abs(got.rmse(test) - want.rmse(test))}
    print(f"port vs JAX on the bundled split: {gaps}")
    assert max(gaps["user"], gaps["item"]) <= chip_smoke.ALS_FACTOR_TOL
    assert gaps["test_predictions"] <= chip_smoke.ALS_PRED_TOL
    assert gaps["rmse"] <= chip_smoke.ALS_RMSE_TOL


def test_chunked_sums_equal_the_direct_path(split, monkeypatch):
    train, _ = split
    cfg = T.ALSConfig(max_iter=3)
    init = jax_init(train, cfg)
    direct = T.train_als(train, cfg, device="cpu", init=init)
    monkeypatch.setattr(T, "ALS_CHUNK_EVENTS", 64)  # many chunks
    chunked = T.train_als(train, cfg, device="cpu", init=init)
    _close(chunked.user_factors, direct.user_factors)
    _close(chunked.item_factors, direct.item_factors)


def test_cross_validate_matches_jax(monkeypatch):
    data = block_ratings(n_users=60, seed=3)
    data = TRatings(data.user_ids, data.movie_ids, data.ratings, data.timestamps)
    cfg = T.ALSConfig(rank=4, max_iter=3)
    want = J.cross_validate(data, J.ALSConfig(rank=4, max_iter=3), reg_grid=(0.01, 0.1),
                            num_folds=4)
    train_als = T.train_als
    monkeypatch.setattr(T, "train_als", lambda r, c, device=None: train_als(
        r, c, device, init=jax_init(r, c)))
    got = T.cross_validate(data, cfg, reg_grid=(0.01, 0.1), num_folds=4, device="cpu")
    assert set(got) == set(want)
    for reg in want:
        assert abs(got[reg] - want[reg]) <= TOL, (reg, got[reg], want[reg])


def test_recommendations_match_jax_where_untied(split):
    train, _ = split
    cfg = T.ALSConfig(rank=4)
    want = J.train_als(train, J.ALSConfig(rank=4))
    got = T.train_als(train, cfg, device="cpu", init=jax_init(train, cfg))
    for mine, theirs, scores in (
        (got.recommend_for_all_users(10, "cpu"), want.recommend_for_all_users(10),
         got.user_factors @ got.item_factors.T),
        (got.recommend_for_all_items(10, "cpu"), want.recommend_for_all_items(10),
         got.item_factors @ got.user_factors.T),
    ):
        assert set(mine) == set(theirs)
        for row, key in enumerate(sorted(mine)):
            s = np.sort(scores[row])[::-1]
            gaps = np.abs(np.diff(s[:11]))
            if gaps.min() > 1e-4:  # no near-tie in the top 10 and the 11th
                assert [m for m, _ in mine[key]] == [m for m, _ in theirs[key]], key
    recs = got.recommend_for_all_users(10, "cpu")
    even = sum(1 for mid, _ in recs[2] if mid % 2 == 0)
    assert even >= 8
    subset = got.recommend_for_user_subset([1, 2, 424242], k=5, device="cpu")
    assert set(subset) == {1, 2} and len(subset[1]) == 5


def test_ties_rank_lowest_index_first():
    """Two identical item factors tie; JAX's order puts the lower index first."""
    model = T.ALSModel(np.array([1]), np.array([10, 20, 30]),
                       np.ones((1, 2), np.float32),
                       np.array([[1, 1], [2, 2], [2, 2]], np.float32))
    assert [m for m, _ in model.recommend_for_all_users(3, "cpu")[1]] == [20, 30, 10]


def test_cold_start_drop(split):
    train, _ = split
    model = T.train_als(train, T.ALSConfig(rank=4), device="cpu")
    unseen = TRatings(np.array([9999], np.int32), np.array([1], np.int32),
                      np.array([3.0], np.float32), np.array([0], np.int64))
    pred, _ = model.transform_drop(unseen)
    assert len(pred) == 0
    assert np.isnan(model.rmse(unseen))

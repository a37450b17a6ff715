"""The port's oracle generators against the JAX package's: the same
arguments give bit-equal features, labels and oracle logits (numpy on the
host in both packages), on the one-pass and the chunked paths."""

import numpy as np
import pytest

from sparrowrecsys_torch.data import synthetic as tsyn
from sparrowrecsys_tpu.data import synthetic as jsyn


def _assert_same(got, want):
    assert list(got.features) == list(want.features)
    for k, v in want.features.items():
        assert got.features[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got.features[k], v, err_msg=k)
    assert got.labels.dtype == want.labels.dtype
    np.testing.assert_array_equal(got.labels, want.labels)


@pytest.mark.parametrize("kw", [
    dict(n=2000, seed=3),
    dict(n=1500, seed=7, t=8, compat_dim=4, gain=4.0, recency=0.8),
    dict(n=800, seed=1, movie_vocab=101, markov_tau=0.0),     # iid history
])
def test_sequence_ctr_with_oracle_bit_equal(kw):
    (got, got_logit), (want, want_logit) = (tsyn.sequence_ctr_with_oracle(**kw),
                                            jsyn.sequence_ctr_with_oracle(**kw))
    _assert_same(got, want)
    assert got_logit.dtype == want_logit.dtype == np.float32
    np.testing.assert_array_equal(got_logit, want_logit)
    # The dataset alone is the same rows.
    _assert_same(tsyn.synthetic_sequence_ctr_dataset(**kw), got)


@pytest.mark.parametrize("kw", [
    dict(n=1000, seed=2, chunk=300),                                   # 4 chunks
    dict(n=700, seed=5, t=7, drift_rho=0.5, tau=1.0, movie_vocab=101, chunk=700),
    dict(n=513, seed=9, t=3, gain=2.0, compat_dim=4, chunk=128),
])
def test_drift_ctr_with_oracle_bit_equal(kw):
    (got, got_logit), (want, want_logit) = (tsyn.drift_ctr_with_oracle(**kw),
                                            jsyn.drift_ctr_with_oracle(**kw))
    _assert_same(got, want)
    assert got_logit.dtype == want_logit.dtype == np.float32
    np.testing.assert_array_equal(got_logit, want_logit)


def test_drift_chunking_leaves_the_rows_alone():
    """The chunk size sets only the draws' blocking: one pass and four
    chunks give the same rows, in both packages."""
    one, _ = tsyn.drift_ctr_with_oracle(600, seed=4, chunk=600)
    four, _ = tsyn.drift_ctr_with_oracle(600, seed=4, chunk=150)
    _assert_same(four, one)


def test_synthetic_sequence_ctr_dataset_still_bit_equal():
    _assert_same(tsyn.synthetic_sequence_ctr_dataset(2000, seed=3),
                 jsyn.synthetic_sequence_ctr_dataset(2000, seed=3))

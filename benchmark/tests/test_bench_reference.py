"""The plain reference against the port at tiny sizes on the CPU: the
serving path's candidate set and features, and DIN's logits."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import din as ref
from benchmark.reference.catalog import Catalog
from benchmark.tests.tiny import REPO

DATA = os.path.join(REPO, "data")


@pytest.fixture(scope="module")
def port_catalog():
    from sparrowrecsys_torch.config import DataConfig
    from sparrowrecsys_torch.serving.assembler import FeatureAssembler
    from sparrowrecsys_torch.serving.feature_store import FeatureStore
    from sparrowrecsys_torch.serving.server import load_catalog

    dm = load_catalog(DataConfig(data_root=DATA))
    return dm, FeatureAssembler(FeatureStore.load(os.path.join(DATA, "feature_store.json")), dm)


def test_candidates_and_features_match_the_port(port_catalog):
    dm, asm = port_catalog
    cat = Catalog(DATA)
    cands = cat.candidates()
    assert cands == [m.movie_id for m in dm.get_movies(800, "rating")]
    assert sorted(cat.users) == sorted(dm.users)
    users = cat.users[::97]
    cols = cat.request_columns(users, cands)
    for i, u in enumerate(users):
        feats = asm.features(u, cands)
        for c, v in cols.items():
            np.testing.assert_array_equal(v[i * len(cands):(i + 1) * len(cands)], feats[c],
                                          err_msg=c)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_logits_match_the_port(dtype, tol):
    from sparrowrecsys_torch.models import build_model
    from sparrowrecsys_torch.training.checkpoint import flax_layout

    cfg = {"dim": 8, "hidden": 16, "attention_hidden": 8, "recent_movies": 4,
           "user_buckets": 1000, "movie_buckets": 500, "compute_dtype": dtype}
    w = weights.make_din(cfg, 2 ** 33 + 5, "cpu")
    model = build_model("din", dim=8, hidden=16, attention_hidden=8, recent_movies=4,
                        user_buckets=1000, movie_buckets=500, compute_dtype=dtype)
    state = {k: (w["/".join(p)].T if t else w["/".join(p)])
             for k, (p, t) in flax_layout(model).items()}
    model.load_state_dict(state)
    feats, _ = weights.train_columns(cfg, {"movie_zipf_s": 1.0, "label_p": 0.5, "history": 4}, 3,
                                     "cpu", 512)
    feats["userRatedMovie4"][::3] = 0          # padded history steps
    with torch.no_grad():
        got = model(feats)
    want = ref.forward(w, feats, 4, torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= tol * scale


def test_lower_precision_rounds():
    x = torch.tensor([1.0 + 2 ** -12, 3.0 + 2 ** -20])
    assert torch.equal(ref._lowered(x, torch.float32), torch.tensor([1.0, 3.0]))
    y = torch.tensor([1.0 + 2 ** -6], dtype=torch.bfloat16)
    assert float(ref._lowered(y, torch.bfloat16)) == 1.0

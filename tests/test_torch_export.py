"""The port's export writer against the JAX package's reader: an export
written by the port (`checkpoint.save` with the pure-Python msgpack
writer) is byte-identical to flax's, restores through JAX's
`checkpoint.load_latest` to the port's parameters, and reads back through
the port's own reader. `training/run.py --cpu` trains and exports."""

import json
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparrowrecsys_torch.data.synthetic import synthetic_ctr_dataset
from sparrowrecsys_torch.models import build_model
from sparrowrecsys_torch.training import run
from sparrowrecsys_torch.training.checkpoint import (
    latest_ready_version,
    load_latest,
    params_from_flax,
    params_to_flax,
    save,
)
from sparrowrecsys_torch.training.loop import Trainer
from sparrowrecsys_torch.training.msgpack_writer import packb
from sparrowrecsys_tpu.models import build_model as jax_build
from sparrowrecsys_tpu.training import checkpoint as jax_ckpt

torch.set_num_threads(2)

SMALL = dict(dim=4, field_dim=8, deep_hidden=8, movie_buckets=50, user_buckets=60)


def _jax_target(name, kwargs, ds):
    feats = {k: jnp.asarray(v[:2]) for k, v in ds.features.items()}
    return jax_build(name, **kwargs).init(jax.random.PRNGKey(0), feats)["params"]


def test_export_is_flax_bytes_and_jax_restores_the_port_params(tmp_path):
    ds = synthetic_ctr_dataset(256, user_vocab=60, movie_vocab=50, seed=2)
    model = build_model("deepfm_v2", **SMALL)
    trainer = Trainer(model, device="cpu")
    params = trainer.fit(ds, epochs=1, batch_size=64, verbose=False).params
    tree = params_to_flax(params, model)
    assert packb(tree) == flax.serialization.msgpack_serialize(tree)

    vdir = save(tree, str(tmp_path), meta={"model": "deepfm_v2"})
    assert os.path.basename(vdir) == "001" and latest_ready_version(str(tmp_path)) == 1
    restored, version, meta = jax_ckpt.load_latest(
        str(tmp_path), _jax_target("deepfm_v2", SMALL, ds))
    assert version == 1 and meta == {"model": "deepfm_v2"}
    flat = jax.tree_util.tree_leaves_with_path(restored)
    assert len(flat) == len(params)
    back = params_from_flax(jax.tree.map(np.asarray, restored), model)
    for k, v in params.items():
        assert torch.equal(back[k], v), k
    tree2, _, _ = load_latest(str(tmp_path))
    for k, v in params_from_flax(tree2, model).items():
        assert torch.equal(v, params[k]), k


def test_save_numbers_versions_writes_meta_last_and_prunes(tmp_path):
    tree = {"a": {"kernel": np.ones((2, 3), np.float32)}, "b": np.zeros(4, np.int32),
            "c": torch.ones(3, dtype=torch.bfloat16)}
    for _ in range(4):
        save(tree, str(tmp_path), keep=2)
    assert sorted(os.listdir(tmp_path)) == ["003", "004"]
    with open(tmp_path / "004" / "meta.json") as f:
        assert json.load(f) == {}
    raw = (tmp_path / "004" / "params.msgpack").read_bytes()
    restored = flax.serialization.msgpack_restore(raw)
    assert str(restored["c"].dtype) == "bfloat16"
    np.testing.assert_array_equal(restored["a"]["kernel"], tree["a"]["kernel"])
    os.remove(tmp_path / "004" / "meta.json")            # a version still being written
    assert latest_ready_version(str(tmp_path)) == 3


def test_run_cli_trains_on_the_cpu_and_exports(tmp_path, capsys):
    run.main(["--cpu", "--model", "din", "--epochs", "1", "--export", str(tmp_path)])
    out = capsys.readouterr().out
    assert "epoch 1/1" in out and "exported checkpoint" in out and "throughput" in out
    tree, version, meta = load_latest(str(tmp_path))
    assert version == 1 and meta["model"] == "din"
    model = build_model("din")
    model.load_state_dict(params_from_flax(tree, model))
    from sparrowrecsys_tpu.data.dataset import encode_samples, load_samples_csv

    ds = encode_samples(load_samples_csv(os.path.join(os.path.dirname(__file__),
                                                      "../data/testSamples.csv")))
    restored, _, _ = jax_ckpt.load_latest(str(tmp_path), _jax_target("din", {}, ds))
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree_util.tree_leaves(restored))


@pytest.mark.parametrize("argv", [
    ["--model", "din", "--cpu", "--resume"],
    ["--model", "din", "--cpu", "--state-dir", "x"], ["--model", "din", "--cpu", "--config", "c.json"],
])
def test_run_cli_raises_for_what_is_not_ported(argv, tmp_path, capsys):
    """--resume, --state-dir and --config raised NotImplementedError until
    the train-state slice; they are ported now, and each runs: --resume
    with no state starts cold, --state-dir writes a train state (its
    opt_state.msgpack beside the params), and --config's train section
    sets the epochs."""
    argv = [str(tmp_path / a) if a in ("x", "c.json") else a for a in argv]
    if "--config" in argv:
        with open(argv[-1], "w") as f:
            json.dump({"train": {"epochs": 1, "batch_size": 4096}}, f)
    else:
        argv += ["--epochs", "1", "--batch-size", "4096"]
    if "--resume" in argv:
        argv += ["--state-dir", str(tmp_path / "none")]
    run.main(argv)
    out = capsys.readouterr().out
    assert "epoch 1/1:" in out and "throughput:" in out
    if "--state-dir" in argv and "--resume" not in argv:
        assert sorted(os.listdir(tmp_path / "x" / "001")) == [
            "meta.json", "opt_state.msgpack", "params.msgpack"]

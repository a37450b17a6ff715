"""The port's flax-msgpack reader and `params_from_flax` against flax itself."""

import glob
import json
import os

import flax.serialization
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from torch import nn

from sparrowrecsys_torch.training.checkpoint import (
    latest_ready_version,
    load_latest,
    params_from_flax,
)
from sparrowrecsys_torch.training.msgpack_reader import unpackb

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPORTS = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "data/modeldata/*/*/params.msgpack"))
)


def _assert_trees_bit_equal(ref, got, path=""):
    assert isinstance(got, dict) == isinstance(ref, dict), path
    if isinstance(ref, dict):
        assert set(ref) == set(got), path
        for k in ref:
            _assert_trees_bit_equal(ref[k], got[k], f"{path}/{k}")
        return
    assert isinstance(got, np.ndarray), path
    assert got.dtype == ref.dtype and got.shape == ref.shape, path
    assert got.tobytes() == np.asarray(ref).tobytes(), path


@pytest.mark.parametrize("rel", EXPORTS)
def test_reader_bit_equal_to_flax_on_every_export(rel):
    with open(os.path.join(REPO, rel), "rb") as f:
        raw = f.read()
    _assert_trees_bit_equal(flax.serialization.msgpack_restore(raw), unpackb(raw))


def test_every_export_found():
    assert len(EXPORTS) >= 20


def test_reader_scalars_strings_and_containers():
    doc = {"i": [0, 1, 127, 128, -1, -33, 2**40, -(2**40)], "f": [0.5, 1e300],
           "s": "x" * 40, "b": b"\x00\x01", "n": None, "t": True, "F": False,
           "nested": {"k": list(range(20))}}
    assert unpackb(msgpack.packb(doc, use_bin_type=True)) == doc


def test_reader_bfloat16_leaf_is_bit_exact():
    x = jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4), jnp.bfloat16)
    got = unpackb(flax.serialization.to_bytes({"w": x}))["w"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (3, 4)
    ref = np.asarray(x).view(np.uint16)
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16), ref)


def test_reader_rejects_other_ext_codes_and_chunked_arrays():
    with pytest.raises(ValueError, match="ext code 2"):
        unpackb(msgpack.packb({"c": msgpack.ExtType(2, b"\x92\x01\x02")}))
    chunked = {"w": {"__msgpack_chunked_array__": True, "shape": {"0": 2},
                     "chunks": {"0": np.zeros(2, np.float32)}}}
    blob = msgpack.packb(chunked, default=flax.serialization._msgpack_ext_pack)
    with pytest.raises(ValueError, match="chunked"):
        unpackb(blob)
    with pytest.raises(ValueError, match="trailing"):
        unpackb(msgpack.packb(1) + b"\x00")


def test_versions_and_readiness(tmp_path):
    d = tmp_path / "m"
    for v, ready in ((1, True), (2, True), (3, False)):
        vd = d / f"{v:03d}"
        vd.mkdir(parents=True)
        (vd / "params.msgpack").write_bytes(
            flax.serialization.to_bytes({"a": np.full(2, v, np.float32)}))
        if ready:
            (vd / "meta.json").write_text(json.dumps({"v": v}))
    assert latest_ready_version(str(d)) == 2
    tree, version, meta = load_latest(str(d))
    assert version == 3 and meta == {} and tree["a"].tolist() == [3.0, 3.0]
    with pytest.raises(FileNotFoundError):
        load_latest(str(tmp_path / "none"))


class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.dense = nn.Linear(3, 2)
        self.table = nn.Parameter(torch.zeros(4, 3))


def _tiny_tree():
    rng = np.random.default_rng(0)
    return {"dense": {"kernel": rng.normal(size=(3, 2)).astype(np.float32),
                      "bias": rng.normal(size=2).astype(np.float32)},
            "table": rng.normal(size=(4, 3)).astype(np.float32)}


def test_params_from_flax_transposes_dense_kernels():
    tree, model = _tiny_tree(), _Tiny()
    model.load_state_dict(params_from_flax(tree, model))
    np.testing.assert_array_equal(model.dense.weight.detach().numpy(), tree["dense"]["kernel"].T)
    np.testing.assert_array_equal(model.dense.bias.detach().numpy(), tree["dense"]["bias"])
    np.testing.assert_array_equal(model.table.detach().numpy(), tree["table"])


@pytest.mark.parametrize("fault", ["missing", "extra", "misshaped"])
def test_params_from_flax_is_strict(fault):
    tree = _tiny_tree()
    if fault == "missing":
        del tree["dense"]["bias"]
        err = KeyError
    elif fault == "extra":
        tree["other"] = {"w": np.zeros(1, np.float32)}
        err = KeyError
    else:
        tree["table"] = np.zeros((4, 5), np.float32)
        err = ValueError
    with pytest.raises(err):
        params_from_flax(tree, _Tiny())

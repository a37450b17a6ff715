"""The port's configuration tree against the JAX package's: the same
sections, field names, defaults and types, so a file written by either
package's `config_to_json` loads in the other; unknown keys raise."""

import dataclasses
import json

import pytest

from sparrowrecsys_torch import config as C
from sparrowrecsys_tpu import config as J

SECTIONS = ("DataConfig", "ModelConfig", "MeshConfig", "TrainConfig", "ServingConfig",
            "SparrowConfig")


@pytest.mark.parametrize("name", SECTIONS)
def test_sections_carry_every_field_default_and_type(name):
    def fields(mod):
        out = {}
        for f in dataclasses.fields(getattr(mod, name)):
            default = f.default_factory() if f.default is dataclasses.MISSING else f.default
            if dataclasses.is_dataclass(default):
                default = dataclasses.asdict(default)
            out[f.name] = (str(f.type), default)
        return out

    assert list(fields(C)) == list(fields(J))
    assert fields(C) == fields(J)


def test_config_from_json_reads_a_jax_written_file(tmp_path):
    cfg = J.SparrowConfig(
        data=J.DataConfig(data_root="/elsewhere", sample_fraction=0.5, split_by_time=True),
        model=J.ModelConfig(compute_dtype="bfloat16"),
        mesh=J.MeshConfig(data_parallel=2, model_parallel=2),
        train=J.TrainConfig(batch_size=512, epochs=3, bf16_table_params=True,
                            big_moment_dtype="bfloat16", shuffle_mode="blocks"),
        serving=J.ServingConfig(neuralcf_aliases=("neuralcf",), webroot="/www", port=7000),
    )
    path = str(tmp_path / "jax.json")
    J.config_to_json(cfg, path)
    got = C.config_from_json(path)
    assert isinstance(got, C.SparrowConfig)
    assert got.serving.neuralcf_aliases == ("neuralcf",)        # a list turned tuple
    assert dataclasses.asdict(got) == dataclasses.asdict(cfg)
    back = str(tmp_path / "port.json")
    C.config_to_json(got, back)
    assert open(back).read() == open(path).read()
    assert J.config_from_json(back) == cfg


def test_default_configs_write_the_same_file(tmp_path):
    C.config_to_json(C.default_config(), str(tmp_path / "port.json"))
    J.config_to_json(J.default_config(), str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()


@pytest.mark.parametrize("blob,where", [
    ({"trian": {}}, "SparrowConfig"),
    ({"train": {"batch": 12}}, "TrainConfig"),
    ({"serving": {"candidates": 800}}, "ServingConfig"),
], ids=["section", "train_key", "serving_key"])
def test_unknown_keys_raise(blob, where, tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(blob))
    with pytest.raises(ValueError, match=where):
        C.config_from_json(str(path))

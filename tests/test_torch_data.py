"""The port's training inputs, configuration and initialisation against
the JAX package's: the sample loader and encoder, the synthetic datasets
(numpy, so the same seed gives the same rows), TrainConfig's fields and
defaults, and the flax initialisers' distributions."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from sparrowrecsys_torch.config import TrainConfig
from sparrowrecsys_torch.data import dataset as tdata
from sparrowrecsys_torch.data import synthetic as tsyn
from sparrowrecsys_torch.models import build_model
from sparrowrecsys_torch.training.loop import Trainer
from sparrowrecsys_tpu import config as jax_config
from sparrowrecsys_tpu.data import dataset as jdata
from sparrowrecsys_tpu.data import synthetic as jsyn

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_same(ds, ref):
    assert list(ds.features) == list(ref.features)
    for k in ref.features:
        assert ds.features[k].dtype == ref.features[k].dtype, k
        np.testing.assert_array_equal(ds.features[k], ref.features[k], err_msg=k)
    np.testing.assert_array_equal(ds.labels, ref.labels)


@pytest.mark.parametrize("name", ["trainingSamples.csv", "testSamples.csv"])
def test_load_and_encode_samples_match_jax(name):
    """Column-equal with the JAX package's loader (its C++ fast path)."""
    path = os.path.join(REPO, "data", name)
    table, ref_table = tdata.load_samples(path), jdata.load_samples(path)
    for k in ref_table.columns:
        np.testing.assert_array_equal(table[k], ref_table[k], err_msg=k)
    ds, ref = tdata.encode_samples(table), jdata.encode_samples(ref_table)
    _assert_same(ds, ref)
    (std, std_test), (ref_std, ref_std_test) = tdata.standardize(ds, ds), jdata.standardize(ref, ref)
    _assert_same(std, ref_std)
    _assert_same(std_test, ref_std_test)


def test_batches_match_jax():
    ds = jsyn.synthetic_ctr_dataset(50, seed=1)
    port = tdata.EncodedDataset(ds.features, ds.labels)
    for shuffle in (False, True):
        got = list(port.batches(16, shuffle=shuffle, seed=3, pad_final=True))
        ref = list(ds.batches(16, shuffle=shuffle, seed=3, pad_final=True))
        assert len(got) == len(ref) == 4
        for (f, lab, m), (rf, rl, rm) in zip(got, ref):
            np.testing.assert_array_equal(lab, rl)
            np.testing.assert_array_equal(f["userId"], rf["userId"])
            assert (m is None) == (rm is None)
        np.testing.assert_array_equal(got[-1][2], ref[-1][2])   # the padded batch's mask


def test_synthetic_datasets_match_jax():
    _assert_same(tsyn.synthetic_ctr_dataset(3000, seed=5), jsyn.synthetic_ctr_dataset(3000, seed=5))
    _assert_same(tsyn.synthetic_sequence_ctr_dataset(2000, movie_vocab=60, seed=6),
                 jsyn.synthetic_sequence_ctr_dataset(2000, movie_vocab=60, seed=6))


def test_train_config_carries_every_field_and_default():
    got = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jax_config.TrainConfig)}
    assert got == ref
    assert TrainConfig().adam_eps == 1e-7
    # Ported: the narrow dtypes construct (they raised before).
    assert TrainConfig(bf16_table_params=True, big_moment_dtype="bfloat16").bf16_table_params
    with pytest.raises(ValueError, match="shuffle_mode"):
        TrainConfig(shuffle_mode="typo")


def test_trainer_raises_for_what_is_not_ported():
    """Mesh plans, the block shuffle and train-state checkpoints, which
    raised before, are ported (tests/test_torch_parallel.py,
    tests/test_torch_narrow.py, tests/test_torch_train_state.py); a batch
    that does not split over the data ranks raises."""
    from sparrowrecsys_torch.parallel import MeshPlan, build_mesh

    model = build_model("deepfm")
    Trainer(model, plan=build_mesh(), device="cpu")
    ds = tsyn.synthetic_ctr_dataset(8)
    with pytest.raises(ValueError, match="data ranks"):
        Trainer(model, TrainConfig(batch_size=5), plan=MeshPlan(n_data=2),
                device="cpu").fit(ds, verbose=False)
    Trainer(model, TrainConfig(shuffle_mode="blocks"), device="cpu")
    with pytest.raises(ValueError, match="big_moment_dtype"):
        Trainer(model, TrainConfig(big_moment_dtype="int8"), device="cpu")


def test_trainer_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(build_model("din"))


@pytest.mark.parametrize("name", ["deepfm", "deepfm_v2", "din"])
def test_init_params_have_the_flax_distributions(name):
    """Tables uniform(-0.05, 0.05); Dense kernels lecun-normal (a normal
    truncated at 2 standard units, std 1/sqrt(fan_in)); biases, slopes and
    id weights 0. The bounds hold exactly; the sample mean and std lie
    within 4 standard errors of their targets for the leaf's size n:
    mean 4 std/sqrt(n), std 4 * 0.45/sqrt(n) relative for the uniform and
    4 * 0.6/sqrt(n) for the truncated normal (from their kurtoses)."""
    model = build_model(name)
    params = Trainer(model, device="cpu").init_params()
    assert set(params) == set(model.state_dict())
    again = Trainer(model, TrainConfig(seed=42), device="cpu").init_params()
    assert all(torch.equal(params[k], again[k]) for k in params)
    linear = {n for n, m in model.named_modules() if isinstance(m, torch.nn.Linear)}
    for key, v in params.items():
        mod, _, leaf = key.rpartition(".")
        assert v.dtype == torch.float32 and v.shape == model.state_dict()[key].shape, key
        n = v.numel()
        if leaf == "table":
            std, bound, se = 0.05 / 3 ** 0.5, 0.05, 0.45
        elif (mod in linear and leaf == "weight") or key in getattr(model, "RAW_KERNELS", ()):
            fan_in = v.shape[1] if leaf == "weight" else v.shape[0]
            std = (1 / fan_in) ** 0.5
            bound, se = 2 * std / 0.87962566103423978, 0.6
        else:
            assert not v.any(), key
            continue
        assert v.abs().max() <= bound + 1e-7, key
        assert abs(v.mean().item()) < 4 * std / n ** 0.5, key
        assert abs(v.std().item() / std - 1) < 4 * se / n ** 0.5, key


@pytest.mark.parametrize("n,batch", [(50, 16), (64, 16)])
def test_epoch_order_visits_every_row_once_and_masks_the_pad(n, batch):
    """The order pads its tail with dataset row 0, masked, and depends on
    the epoch through the seed."""
    trainer = Trainer(build_model("deepfm"), device="cpu")
    padded = -(-n // batch) * batch
    order, valid = trainer._epoch_order(n, padded, epoch=0, orders=None)
    assert order.shape == valid.shape == (padded,)
    assert sorted(order[valid > 0].tolist()) == list(range(n))
    assert order[valid == 0].eq(0).all() and int(valid.sum()) == n
    again, _ = trainer._epoch_order(n, padded, epoch=0, orders=None)
    other, _ = trainer._epoch_order(n, padded, epoch=1, orders=None)
    assert torch.equal(order, again) and not torch.equal(order, other)


def test_fit_from_host_columns_equals_fit_from_resident_columns():
    ds = tsyn.synthetic_ctr_dataset(300, seed=9)
    results = []
    for resident_bytes in (2 << 30, 0):
        trainer = Trainer(build_model("deepfm", dim=4, deep_hidden=8), device="cpu")
        trainer.device_resident_bytes = resident_bytes
        results.append(trainer.fit(ds, epochs=1, batch_size=64, verbose=False))
    for k, v in results[0].params.items():
        assert torch.equal(v, results[1].params[k]), k
    assert results[0].history == results[1].history

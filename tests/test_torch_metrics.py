"""The port's metrics against the JAX package's on the same numpy inputs:
the 200-threshold streaming state with Keras's sentinel thresholds, its
finalisation, and the exact sort-based AUCs."""

import jax.numpy as jnp
import numpy as np
import torch

from sparrowrecsys_torch.ops import metrics as M
from sparrowrecsys_torch.training.evaluator import evaluate_predictions
from sparrowrecsys_tpu.ops import metrics as JM

torch.set_num_threads(2)


def test_streaming_metrics_match_jax():
    """The counts are exact; the finalised float32 AUCs agree to 1e-6."""
    rng = np.random.default_rng(0)
    js, ts = JM.init_metrics(), M.init_metrics()
    for b in range(3):
        probs = rng.random(500).astype(np.float32)
        probs[:5] = [0.0, 1.0, 0.5, 1e-8, 1 - 1e-8]      # at and near the sentinels
        labels = (rng.random(500) < probs).astype(np.float32)
        loss_sum = np.float32(rng.random() * 100)
        mask = None if b == 0 else (rng.random(500) < 0.8).astype(np.float32)
        js = JM.update_metrics(js, jnp.asarray(probs), jnp.asarray(labels), jnp.asarray(loss_sum),
                               None if mask is None else jnp.asarray(mask))
        ts = M.update_metrics(ts, torch.from_numpy(probs), torch.from_numpy(labels),
                              torch.tensor(loss_sum), None if mask is None else torch.from_numpy(mask))
    for name in M.MetricState._fields:
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)
    ref = {k: float(v) for k, v in JM.finalize_metrics(js).items()}
    got = M.finalize_metrics(ts)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_thresholds_are_kerases():
    np.testing.assert_array_equal(M._thresholds("cpu").numpy(), np.asarray(JM._thresholds()))


def test_exact_auc_and_evaluator_match_jax(capsys):
    rng = np.random.default_rng(1)
    probs = np.round(rng.random(2000), 2)            # ties
    labels = (rng.random(2000) < probs).astype(np.float32)
    ref = JM.exact_auc(probs, labels)
    assert M.exact_auc(probs, labels) == ref
    assert evaluate_predictions(probs, labels) == ref
    assert "AUC under ROC" in capsys.readouterr().out
    nan = M.exact_auc(probs, np.ones_like(labels))
    assert np.isnan(nan["roc_auc"]) and np.isnan(nan["pr_auc"])

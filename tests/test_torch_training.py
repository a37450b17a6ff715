"""Two-epoch `Trainer.fit`, the port against the JAX package, from JAX's
initial weights and JAX's row order (`PRNGKey(seed + epoch)`), on the CPU:
DeepFM v1 and DIN on the bundled CSVs as they are, DeepFMv2 on synthetic
N(0, 1) numerics (raw releaseYear near 2000 would make it float32-noisy),
and DeepFMv2 with a sparse user table and n % batch != 0, where the
padded rows (dataset row 0) are touched rows of the lazy row-Adam.

Tolerances: per-epoch loss 1e-5 relative, streaming AUC 1e-5 absolute;
final parameters 1e-4 of each leaf's scale (measured: at most 2e-5, and
no element flips the sign of its first Adam step, which would show as
2 * lr = 2e-3)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparrowrecsys_torch.config import TrainConfig
from sparrowrecsys_torch.data.dataset import EncodedDataset, encode_samples, load_samples
from sparrowrecsys_torch.data.synthetic import synthetic_ctr_dataset
from sparrowrecsys_torch.models import build_model
from sparrowrecsys_torch.ops import kernels
from sparrowrecsys_torch.training.checkpoint import params_from_flax, params_to_flax
from sparrowrecsys_torch.training.loop import Trainer
from sparrowrecsys_tpu.config import TrainConfig as JaxTrainConfig
from sparrowrecsys_tpu.data.dataset import EncodedDataset as JaxEncodedDataset
from sparrowrecsys_tpu.models import build_model as jax_build
from sparrowrecsys_tpu.ops import metrics as JM
from sparrowrecsys_tpu.training.loop import Trainer as JaxTrainer

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {
    "deepfm": dict(dim=4, deep_hidden=8),
    "deepfm_v2": dict(dim=4, field_dim=8, deep_hidden=8),
    "din": dict(dim=4, attention_hidden=8, hidden=16),
}
SEED, EPOCHS = 42, 2


def _data(source, n):
    if source == "csv":
        ds = encode_samples(load_samples(os.path.join(REPO, "data/trainingSamples.csv")))
    else:
        ds = synthetic_ctr_dataset(n, seed=3)
    return EncodedDataset({k: v[:n] for k, v in ds.features.items()}, ds.labels[:n])


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_epochs(jt, params, ds, batch):
    """JAX's fit, resident path (loop.py:553-562), one epoch at a time so
    the optimizer state (the fused row buffers) stays in reach."""
    jt._build_steps()
    opt = jt.init_opt_state(params)
    if jt.sparse_tables:
        params = jt._dense_view(params)
    data = {k: jnp.asarray(v) for k, v in ds.features.items()}
    labels = jnp.asarray(ds.labels)
    history = []
    for epoch in range(EPOCHS):
        params, opt, m = jt._train_epoch(
            params, opt, JM.init_metrics(), data, labels, jax.random.PRNGKey(SEED + epoch),
            n=len(ds), batch_size=batch, shuffle=True)
        history.append({k: float(v) for k, v in JM.finalize_metrics(m).items()})
    if jt.sparse_tables:
        params = jt._materialize_tables(params, opt)
    return params, opt, history


@pytest.mark.parametrize("name,source,n,batch,sparse", [
    ("deepfm", "csv", 4096, 512, False),
    ("deepfm_v2", "synthetic", 1024, 128, False),
    ("din", "csv", 4096, 512, False),
    ("deepfm_v2", "synthetic", 1000, 64, True),
], ids=["deepfm_csv", "deepfm_v2_synthetic", "din_csv", "deepfm_v2_sparse_padded"])
def test_two_epoch_fit_matches_jax(name, source, n, batch, sparse):
    ds = _data(source, n)
    n = len(ds)
    jds = JaxEncodedDataset(ds.features, ds.labels)
    tables = {"emb_userId": ("userId",)} if sparse else None
    jt = JaxTrainer(jax_build(name, **SMALL[name]),
                    JaxTrainConfig(batch_size=batch, epochs=EPOCHS, seed=SEED), sparse_tables=tables)
    init = jax.tree.map(lambda a: np.array(a), jt.init_params(jds.features))
    orders = [np.asarray(jax.random.permutation(jax.random.PRNGKey(SEED + e), n))
              for e in range(EPOCHS)]

    model = build_model(name, **SMALL[name])
    trainer = Trainer(model, TrainConfig(batch_size=batch, epochs=EPOCHS, seed=SEED),
                      sparse_tables=tables, device="cpu")
    launches = kernels.launch_counts()
    result = trainer.fit(ds, params=params_from_flax(init, model), orders=orders, verbose=False)
    assert kernels.launch_counts() == launches   # plain on the CPU

    if sparse:
        ref_params, ref_opt, ref_history = _jax_epochs(jt, jax.tree.map(jnp.asarray, init), jds, batch)
        buf = result.opt_state["rows"]["emb_userId"].buf.numpy()
        ref_buf = np.asarray(ref_opt["rows"]["emb_userId"].buf)
        assert n % batch and buf.shape == ref_buf.shape == (30001, 12)
        np.testing.assert_allclose(buf, ref_buf, rtol=1e-4, atol=1e-6)
        # Row 0's user takes a step in each epoch's padded last batch.
        row0 = int(ds.features["userId"][0])
        assert np.abs(ref_buf[row0, 4:]).max() > 0 and np.abs(buf[row0, 4:]).max() > 0
    else:
        ref = jt.fit(jds, params=jax.tree.map(jnp.asarray, init), verbose=False)
        ref_params, ref_history = ref.params, ref.history

    assert len(result.history) == EPOCHS
    for got, want in zip(result.history, ref_history):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        for k in ("roc_auc", "pr_auc", "accuracy"):
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    got, want = _flat(params_to_flax(result.params, model)), _flat(ref_params)
    assert set(got) == set(want)
    for k, ref_leaf in want.items():
        scale = max(np.abs(ref_leaf).max(), 1e-3)
        off = int((np.abs(got[k] - ref_leaf) > 1e-4 * scale).sum())
        assert off == 0, f"{k}: {off} of {ref_leaf.size} elements beyond 1e-4 of scale {scale}"
    # The training signal moved the weights.
    assert any(np.abs(want[k] - _flat(init)[k]).max() > 1e-4 for k in want)

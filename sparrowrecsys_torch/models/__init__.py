"""The CTR ranking model zoo: the port of `sparrowrecsys_tpu/models`, and
DLRM-DCNv2 beside it.

Each is an `nn.Module` mapping a feature dict of tensors to logits [B]
(DIEN: to (logits, aux)). The eight ported models keep the flax parameter
names of their counterparts, so `training.checkpoint.params_from_flax`
loads their exports. `dlrm_dcnv2` (`models/dlrm.py`, the MLPerf
recommendation benchmark's model) has no counterpart in the JAX package:
its tests hold it against the plain reference `reference/dlrm_dcnv2.py`.
"""

from __future__ import annotations

from typing import Callable, Dict

from sparrowrecsys_torch.models.deepfm import DeepFM, DeepFMv2
from sparrowrecsys_torch.models.dien import DIEN
from sparrowrecsys_torch.models.din import DIN
from sparrowrecsys_torch.models.dlrm import DLRMDCNv2
from sparrowrecsys_torch.models.embedding_mlp import EmbeddingMLP
from sparrowrecsys_torch.models.neuralcf import NeuralCF, NeuralCFTwoTower
from sparrowrecsys_torch.models.wide_deep import WideNDeep

#: name -> constructor with the reference's default hyperparameters.
MODEL_REGISTRY: Dict[str, Callable] = {
    "embedding_mlp": EmbeddingMLP,
    "wide_deep": WideNDeep,
    "neuralcf": NeuralCF,
    "neuralcf_two_tower": NeuralCFTwoTower,
    "deepfm": DeepFM,
    "deepfm_v2": DeepFMv2,
    "din": DIN,
    "dien": DIEN,
    "dlrm_dcnv2": DLRMDCNv2,
}


def build_model(name: str, **kwargs):
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](**kwargs)

"""The CTR ranking models ported so far.

Each is an `nn.Module` mapping a feature dict of tensors to logits [B],
with the flax parameter names of its counterpart in
`sparrowrecsys_tpu.models`.
"""

from __future__ import annotations

from typing import Callable, Dict

from sparrowrecsys_torch.models.deepfm import DeepFM, DeepFMv2
from sparrowrecsys_torch.models.din import DIN

#: name -> constructor with the reference's default hyperparameters.
MODEL_REGISTRY: Dict[str, Callable] = {
    "deepfm": DeepFM,
    "deepfm_v2": DeepFMv2,
    "din": DIN,
}

#: Zoo models of the JAX package that are not ported yet (ROADMAP.md).
QUEUED = ("dien", "embedding_mlp", "neuralcf", "neuralcf_two_tower", "wide_deep")


def build_model(name: str, **kwargs):
    if name in QUEUED:
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet; it is queued in ROADMAP.md"
        )
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](**kwargs)

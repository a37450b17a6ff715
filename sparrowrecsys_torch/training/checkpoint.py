"""Versioned model checkpoints, load side: `<dir>/<NNN>/params.msgpack`.

The port of `sparrowrecsys_tpu/training/checkpoint.py:60-108`. The JAX
loader restores into a target tree built by `model.init`; here the file
is decoded on its own (`msgpack_reader.unpackb`) into a nested dict of
arrays, and `params_from_flax` maps that dict onto a torch module's
`state_dict` by name, so no init pass is needed.
"""

from __future__ import annotations

import json
import os
import re
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sparrowrecsys_torch.training.msgpack_reader import unpackb

_VERSION_RE = re.compile(r"^\d{3,}$")


def _versions(model_dir: str):
    if not os.path.isdir(model_dir):
        return []
    return sorted(int(d) for d in os.listdir(model_dir) if _VERSION_RE.match(d))


def latest_ready_version(model_dir: str) -> Optional[int]:
    """Newest version whose export is complete: `meta.json` is written
    last, so a version dir without it is still being written and must
    not be served."""
    for v in reversed(_versions(model_dir)):
        vdir = os.path.join(model_dir, f"{v:03d}")
        if os.path.exists(os.path.join(vdir, "meta.json")) and os.path.exists(
            os.path.join(vdir, "params.msgpack")
        ):
            return v
    return None


def load_version(model_dir: str, version: int) -> Tuple[Dict[str, Any], dict]:
    """Decode one numbered version: (param tree, meta)."""
    vdir = os.path.join(model_dir, f"{version:03d}")
    with open(os.path.join(vdir, "params.msgpack"), "rb") as f:
        tree = unpackb(f.read())
    meta = {}
    meta_path = os.path.join(vdir, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return tree, meta


def load_latest(model_dir: str) -> Tuple[Dict[str, Any], int, dict]:
    """Decode the highest version: (param tree, version, meta)."""
    versions = _versions(model_dir)
    if not versions:
        raise FileNotFoundError(f"no checkpoint versions under {model_dir}")
    v = versions[-1]
    tree, meta = load_version(model_dir, v)
    return tree, v, meta


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def params_from_flax(tree: Dict[str, Any], model: nn.Module) -> "OrderedDict[str, torch.Tensor]":
    """Map a flax param tree onto `model.state_dict()` names.

    `<module>/<param>` becomes `<module>.<param>`. A Dense `kernel
    [in, out]` under an `nn.Linear` becomes its `weight [out, in]`.
    Strict: a missing, extra or mis-shaped name raises `KeyError` or
    `ValueError`. Tensors come back on the CPU in the tree's dtype."""
    flat = _flatten(tree)
    linear = {name for name, m in model.named_modules() if isinstance(m, nn.Linear)}
    want = model.state_dict()
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    used = set()
    for key, ref in want.items():
        mod, _, leaf = key.rpartition(".")
        transpose = mod in linear and leaf == "weight"
        src = (f"{mod}/" if mod else "") + ("kernel" if transpose else leaf)
        if src not in flat:
            raise KeyError(f"flax tree has no {src!r} for {key!r}")
        arr = flat[src]
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.asarray(arr))
        if transpose:
            t = t.T.contiguous()
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(
                f"{src!r}: shape {tuple(t.shape)} does not fit {key!r} "
                f"{tuple(ref.shape)}"
            )
        out[key] = t
        used.add(src)
    extra = sorted(set(flat) - used)
    if extra:
        raise KeyError(f"flax tree has names the model lacks: {extra}")
    return out

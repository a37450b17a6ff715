"""Versioned model checkpoints: `<dir>/<NNN>/params.msgpack` + `meta.json`.

The port of `sparrowrecsys_tpu/training/checkpoint.py:26-97`. The JAX
loader restores into a target tree built by `model.init`; here the file
is decoded on its own (`msgpack_reader.unpackb`) into a nested dict of
arrays, and `params_from_flax` maps that dict onto a torch module's
`state_dict` by name, so no init pass is needed. `save` writes a flax
tree (`params_to_flax` of a port parameter dict) with the pure-Python
`msgpack_writer.packb`, byte for byte what `flax.serialization.to_bytes`
writes, so the JAX package loads the port's exports.

Train-state checkpoints (`save_train_state`, `load_latest_train_state`)
are not ported yet; they are queued in ROADMAP.md.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sparrowrecsys_torch.training.msgpack_reader import unpackb
from sparrowrecsys_torch.training.msgpack_writer import packb

_VERSION_RE = re.compile(r"^\d{3,}$")


def _versions(model_dir: str):
    if not os.path.isdir(model_dir):
        return []
    return sorted(int(d) for d in os.listdir(model_dir) if _VERSION_RE.match(d))


def save(
    params: Dict[str, Any],
    model_dir: str,
    version: Optional[int] = None,
    meta: Optional[dict] = None,
    keep: Optional[int] = None,
) -> str:
    """Write a flax param tree into the next (or given) numbered version
    dir: `params.msgpack` first, then `meta.json`, whose presence marks
    the version complete (`latest_ready_version`). `keep` prunes to the
    newest N versions (TrainConfig.checkpoint_keep). Returns the dir."""
    existing = _versions(model_dir)
    if version is None:
        version = (existing[-1] + 1) if existing else 1
    vdir = os.path.join(model_dir, f"{version:03d}")
    os.makedirs(vdir, exist_ok=True)
    with open(os.path.join(vdir, "params.msgpack"), "wb") as f:
        f.write(packb(params))
    with open(os.path.join(vdir, "meta.json"), "w") as f:
        json.dump(meta or {}, f)
    if keep:
        for v in _versions(model_dir)[:-keep]:
            shutil.rmtree(os.path.join(model_dir, f"{v:03d}"), ignore_errors=True)
    return vdir


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
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.array(arr))
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


def params_to_flax(params: Dict[str, torch.Tensor], model: nn.Module) -> Dict[str, Any]:
    """The inverse of `params_from_flax`: a parameter dict keyed by
    `state_dict` name -> the flax tree of numpy arrays. `<module>.<param>`
    becomes `{module: {param: ...}}`; an `nn.Linear` weight [out, in]
    becomes its Dense `kernel` [in, out]. bfloat16 leaves stay torch
    tensors (numpy has no bfloat16); `msgpack_writer` packs both."""
    linear = {name for name, m in model.named_modules() if isinstance(m, nn.Linear)}
    want = model.state_dict()
    if set(params) != set(want):
        raise KeyError(f"params and model differ: {sorted(set(params) ^ set(want))}")
    tree: Dict[str, Any] = {}
    for key in want:
        mod, _, leaf = key.rpartition(".")
        t = params[key].detach().cpu()
        if mod in linear and leaf == "weight":
            leaf, t = "kernel", t.T
        node = tree
        for part in mod.split(".") if mod else ():
            node = node.setdefault(part, {})
        node[leaf] = t.contiguous() if t.dtype == torch.bfloat16 else t.contiguous().numpy()
    return tree

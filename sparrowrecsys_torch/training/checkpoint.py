"""Versioned model checkpoints: `<dir>/<NNN>/params.msgpack` + `meta.json`.

The port of `sparrowrecsys_tpu/training/checkpoint.py:26-97`. The JAX
loader restores into a target tree built by `model.init`; here the file
is decoded on its own (`msgpack_reader.unpackb`) into a nested dict of
arrays, and `params_from_flax` maps that dict onto a torch module's
`state_dict` by name, so no init pass is needed. `save` writes a flax
tree (`params_to_flax` of a port parameter dict) with the pure-Python
`msgpack_writer.packb`, byte for byte what `flax.serialization.to_bytes`
writes, so the JAX package loads the port's exports.

Train-state checkpoints (`save_train_state`, `load_latest_train_state`,
the port of `:100-153`) add `opt_state.msgpack` and `next_epoch` in the
meta, in flax's state-dict layout, so either package resumes from the
other's state:

- `GroupedAdamState` is a map of its fields in order (`count`, `mu_vec`,
  `nu_vec`, `mu_big`, `nu_big`, `master_big`), each list a map
  {"0": ..., "1": ...}; with sparse tables the top level is
  `{"dense": <that>, "rows": {module: {"count", "buf"}}}`, and the
  params hold empty (0,) placeholders for the tables, whose values live
  in the fused row buffers (`training/row_optim.py`).
- JAX orders leaves by flattening its param tree (sorted module names,
  then sorted leaf names) and keeps Dense kernels [in, out]; the port
  orders them as its `state_dict` and keeps `nn.Linear.weight`
  [out, in]. So the fused small-leaf moment vectors are cut into their
  leaves, each transposed where the param is, and put together again in
  the other order; the big-leaf lists are reordered the same way.
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
from sparrowrecsys_torch.training.optim import GroupedAdamState, split_leaves
from sparrowrecsys_torch.training.row_optim import FusedRowAdamState

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


def params_from_flax(tree: Dict[str, Any], model: nn.Module,
                     target: Optional[Dict[str, torch.Tensor]] = None
                     ) -> "OrderedDict[str, torch.Tensor]":
    """Map a flax param tree onto `model.state_dict()` names (or onto the
    names and shapes of `target`, e.g. a train state's params with their
    sparse tables' placeholders).

    `<module>/<param>` becomes `<module>.<param>`. A Dense `kernel
    [in, out]` under an `nn.Linear` becomes its `weight [out, in]`.
    Strict: a missing, extra or mis-shaped name raises `KeyError` or
    `ValueError`. Tensors come back on the CPU in the tree's dtype."""
    flat = _flatten(tree)
    linear = {name for name, m in model.named_modules() if isinstance(m, nn.Linear)}
    want = model.state_dict() if target is None else target
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    used = set()
    for key, ref in want.items():
        mod, _, leaf = key.rpartition(".")
        transpose = mod in linear and leaf == "weight"
        src = (f"{mod}/" if mod else "") + ("kernel" if transpose else leaf)
        if src not in flat:
            raise KeyError(f"flax tree has no {src!r} for {key!r}")
        t = _tensor(flat[src])
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
    layout = flax_layout(model)
    if set(params) != set(layout):
        raise KeyError(f"params and model differ: {sorted(set(params) ^ set(layout))}")
    tree: Dict[str, Any] = {}
    for key, (path, transpose) in layout.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = _flax_leaf(params[key], transpose)
    return tree


def flax_layout(model: nn.Module) -> "OrderedDict[str, Tuple[Tuple[str, ...], bool]]":
    """`state_dict` name -> (the flax path, whether the flax leaf is the
    transpose: an `nn.Linear.weight`, which flax keeps as `kernel`)."""
    linear = {name for name, m in model.named_modules() if isinstance(m, nn.Linear)}
    out: "OrderedDict[str, Tuple[Tuple[str, ...], bool]]" = OrderedDict()
    for key in model.state_dict():
        mod, _, leaf = key.rpartition(".")
        transpose = mod in linear and leaf == "weight"
        parts = tuple(mod.split(".")) if mod else ()
        out[key] = (parts + ("kernel" if transpose else leaf,), transpose)
    return out


def _flax_leaf(t: torch.Tensor, transpose: bool):
    """A port tensor as the flax leaf: on the host, transposed where the
    layout says so; numpy, or a torch tensor for bfloat16 (numpy lacks it)."""
    t = t.detach().cpu()
    t = (t.T if transpose else t).contiguous()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _tensor(arr) -> torch.Tensor:
    """A leaf as a torch tensor (a copy). numpy has no bfloat16 of its own:
    a bfloat16 array from the `ml_dtypes` package, as a JAX tree in memory
    holds, moves as its raw 2-byte words."""
    if isinstance(arr, torch.Tensor):
        return arr
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _port_leaf(arr, transpose: bool, device) -> torch.Tensor:
    """The inverse of `_flax_leaf`, onto `device`."""
    t = _tensor(arr)
    return (t.T if transpose else t).contiguous().to(device)


# ---- full train-state checkpoint/resume -------------------------------------

class NotATrainStateError(RuntimeError):
    """The newest version dir holds a params-only export (no optimizer
    state): resuming from it would be a silent cold start."""


def _jax_order(names, layout):
    """`names` in the JAX package's leaf order (its tree flattening)."""
    return sorted(names, key=lambda k: layout[k][0])


def _vec_to_flax(vec: torch.Tensor, names, params, layout) -> np.ndarray:
    """A fused small-leaf vector in the port's order and layout -> JAX's."""
    vec = vec.detach().cpu()
    if not names:
        return vec.numpy()
    pieces = dict(zip(names, torch.split(vec, [params[k].numel() for k in names])))
    parts = []
    for k in _jax_order(names, layout):
        t = pieces[k].view(params[k].shape)
        parts.append((t.T if layout[k][1] else t).reshape(-1))
    return torch.cat(parts).numpy()


def _vec_from_flax(arr, names, params, layout, device) -> torch.Tensor:
    """The inverse of `_vec_to_flax`."""
    flat = _tensor(arr)
    total = sum(params[k].numel() for k in names)
    if flat.shape != (total,):
        raise ValueError(f"fused moment vector of shape {tuple(flat.shape)}, want ({total},)")
    order = _jax_order(names, layout)
    pieces = dict(zip(order, torch.split(flat, [params[k].numel() for k in order])))
    parts = []
    for k in names:
        shape = tuple(params[k].shape)
        if layout[k][1]:
            parts.append(pieces[k].view(shape[::-1]).T.reshape(-1))
        else:
            parts.append(pieces[k])
    return (torch.cat(parts) if parts else flat).to(device)


def _list_to_flax(values, names, layout) -> "OrderedDict[str, Any]":
    """A per-big-leaf list (port order) -> flax's {"0": ...} in JAX's order."""
    by_name = dict(zip(names, values))
    return OrderedDict(
        (str(i), None if by_name[k] is None else _flax_leaf(by_name[k], layout[k][1]))
        for i, k in enumerate(_jax_order(names, layout)))


def _list_from_flax(tree, names, layout, device) -> list:
    order = _jax_order(names, layout)
    if sorted(tree) != sorted(str(i) for i in range(len(order))):
        raise ValueError(f"a per-leaf list with keys {sorted(tree)}, want {len(order)} leaves")
    by_name = {k: tree[str(i)] for i, k in enumerate(order)}
    return [None if by_name[k] is None else _port_leaf(by_name[k], layout[k][1], device)
            for k in names]


def _adam_to_flax(state, params, layout) -> "OrderedDict[str, Any]":
    small, big = split_leaves(params)
    return OrderedDict([
        ("count", state.count.detach().cpu().numpy()),
        ("mu_vec", _vec_to_flax(state.mu_vec, small, params, layout)),
        ("nu_vec", _vec_to_flax(state.nu_vec, small, params, layout)),
        ("mu_big", _list_to_flax(state.mu_big, big, layout)),
        ("nu_big", _list_to_flax(state.nu_big, big, layout)),
        ("master_big", _list_to_flax(state.master_big, big, layout)
         if isinstance(state.master_big, list) else OrderedDict()),
    ])


def _adam_from_flax(tree, params, template, layout):
    fields = set(GroupedAdamState._fields)
    if set(tree) != fields:
        raise ValueError(f"optimizer state with fields {sorted(tree)}, want {sorted(fields)}")
    small, big = split_leaves(params)
    dev = template.count.device
    masters = (_list_from_flax(tree["master_big"], big, layout, dev)
               if isinstance(template.master_big, list) else ())
    if not masters and tree["master_big"]:
        raise ValueError("the state holds float32 masters; this run keeps none")
    return GroupedAdamState(
        count=_tensor(tree["count"]).to(dev, torch.int32),
        mu_vec=_vec_from_flax(tree["mu_vec"], small, params, layout, dev),
        nu_vec=_vec_from_flax(tree["nu_vec"], small, params, layout, dev),
        mu_big=_list_from_flax(tree["mu_big"], big, layout, dev),
        nu_big=_list_from_flax(tree["nu_big"], big, layout, dev),
        master_big=masters,
    )


def opt_state_to_flax(opt_state, params, model: nn.Module):
    """The Trainer's optimizer state -> the JAX package's state dict.
    `params` are the ones the optimizer was initialised on (with sparse
    tables, their dense view)."""
    layout = flax_layout(model)
    if not isinstance(opt_state, dict):
        return _adam_to_flax(opt_state, params, layout)
    return {
        "dense": _adam_to_flax(opt_state["dense"], params, layout),
        "rows": {mod: OrderedDict([("count", s.count.detach().cpu().numpy()),
                                   ("buf", _flax_leaf(s.buf, False))])
                 for mod, s in opt_state["rows"].items()},
    }


def opt_state_from_flax(tree, params, template, model: nn.Module):
    """The inverse of `opt_state_to_flax`; `template` (the Trainer's fresh
    state) gives the structure and the device."""
    layout = flax_layout(model)
    if not isinstance(template, dict):
        return _adam_from_flax(tree, params, template, layout)
    if set(tree) != {"dense", "rows"} or set(tree["rows"]) != set(template["rows"]):
        raise ValueError(f"a train state with {sorted(tree)} / rows "
                         f"{sorted(tree.get('rows', {}))}; this run has sparse tables "
                         f"{sorted(template['rows'])}")
    rows = {}
    for mod, t in template["rows"].items():
        saved = tree["rows"][mod]
        buf = _port_leaf(saved["buf"], False, t.buf.device)
        if buf.shape != t.buf.shape:
            raise ValueError(f"rows[{mod}].buf of shape {tuple(buf.shape)}, "
                             f"want {tuple(t.buf.shape)}")
        rows[mod] = FusedRowAdamState(
            count=_tensor(saved["count"]).to(t.count.device, torch.int32),
            buf=buf)
    return {"dense": _adam_from_flax(tree["dense"], params, template["dense"], layout),
            "rows": rows}


def save_train_state(
    model: nn.Module,
    params: Dict[str, torch.Tensor],
    opt_state: Any,
    next_epoch: int,
    state_dir: str,
    keep: Optional[int] = None,
    extra_meta: Optional[dict] = None,
) -> str:
    """Checkpoint the whole train state under the next numbered version:
    `<state_dir>/<NNN>/{params.msgpack, opt_state.msgpack, meta.json}`,
    `meta.json` holding `next_epoch`. `params` and `opt_state` are the
    Trainer's (with sparse tables: the params' placeholders and the fused
    row buffers)."""
    meta = dict(extra_meta or {})
    meta["next_epoch"] = int(next_epoch)
    vdir = save(params_to_flax(params, model), state_dir, meta=meta, keep=keep)
    with open(os.path.join(vdir, "opt_state.msgpack"), "wb") as f:
        f.write(packb(opt_state_to_flax(opt_state, params, model)))
    return vdir


def load_latest_train_state(
    state_dir: str, model: nn.Module, params_target: Dict[str, torch.Tensor],
    opt_state_target: Any,
) -> Tuple[Dict[str, torch.Tensor], Any, int, dict]:
    """(params, opt_state, next_epoch, meta) from the newest version, on
    the targets' devices. The targets (the Trainer's fresh params in their
    fit form and `init_opt_state` of them) give names, shapes and the
    optimizer's structure. No version at all raises FileNotFoundError; a
    params-only export raises NotATrainStateError."""
    tree, v, meta = load_latest(state_dir)
    opt_path = os.path.join(state_dir, f"{v:03d}", "opt_state.msgpack")
    if not os.path.exists(opt_path):
        raise NotATrainStateError(
            f"{os.path.dirname(opt_path)} has no opt_state.msgpack: it is a params-only "
            "export, not a train-state checkpoint")
    loaded = params_from_flax(tree, model, target=params_target)
    params = OrderedDict((k, t.to(params_target[k].device)) for k, t in loaded.items())
    with open(opt_path, "rb") as f:
        opt_tree = unpackb(f.read())
    opt_state = opt_state_from_flax(opt_tree, params_target, opt_state_target, model)
    return params, opt_state, int(meta.get("next_epoch", 0)), meta

"""DIEN's weights and a DIEN training job's columns, made on the device
from the seed in a few large calls.

The weights follow the distributions of the JAX package's initialisers:
tables uniform(-0.05, 0.05); kernels lecun-normal (a normal truncated to
two standard deviations, of variance 1/fan_in, fan_in the kernel's first
dimension), the GRU's recurrent kernel orthogonal (as flax's
`orthogonal()` draws it); biases and PReLU slopes zero. A configuration's
`numeric_scale` divides fc1's rows for each raw numeric column by that
column's typical size, as `weights.make_din` does for DIN. They are keyed
by the export's names (`reference/dien.py::param_shapes`).

The columns are `weights.train_columns`' (the candidate and the history
Zipf over the movie table, users uniform, genres, numerics, labels) and
the negatives `negativeUserRatedMovie2..T`: for each history step after
the first, r uniform over [0, V - 1) and r + (r >= that step's id), uniform
over [0, V) without the step's positive, as the program's
`sample_negatives_in_graph` draws them.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark import weights
from benchmark.reference import dien as ref
from benchmark.reference.din import truncated_normal


def make_dien(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every DIEN parameter, float32 on `device`."""
    g = torch.Generator(device=device).manual_seed(weights.sub_seed(seed, 1))
    shapes = ref.param_shapes(cfg["dim"], cfg["hidden"], cfg["user_buckets"],
                              cfg["movie_buckets"])
    tables = [k for k in shapes if k.endswith("/table")]
    kernels = [k for k in shapes if k.endswith("/kernel") or k == "gru_kernel"
               or (k.startswith("augru_") and k[-1] in "wu")]
    out: Dict[str, torch.Tensor] = {}
    sizes = [math.prod(shapes[k]) for k in tables]
    flat = torch.rand(sum(sizes), generator=g, device=device, dtype=torch.float32)
    flat.mul_(0.1).sub_(0.05)
    for k, piece in zip(tables, flat.split(sizes)):
        out[k] = piece.view(shapes[k])
    sizes = [math.prod(shapes[k]) for k in kernels]
    flat = truncated_normal(sum(sizes), g, device)
    for k, piece in zip(kernels, flat.split(sizes)):
        out[k] = piece.view(shapes[k]) * (math.sqrt(1.0 / shapes[k][0]) / weights._TRUNC_STD)
    out["gru_recurrent"] = torch.nn.init.orthogonal_(
        torch.empty(shapes["gru_recurrent"], device=device), generator=g)
    scale = cfg.get("numeric_scale")
    if scale:
        rows = ref.fc1_numeric_rows(cfg["dim"])
        div = torch.tensor([float(scale[c]) for c in rows], device=device)
        idx = torch.tensor(list(rows.values()), device=device)
        out["fc1/kernel"][idx] /= div[:, None]
    for k, shape in shapes.items():
        if k not in out:
            out[k] = torch.zeros(shape, dtype=torch.float32, device=device)
    return {k: out[k] for k in shapes}


def train_columns(cfg: dict, traffic: dict, seed: int, device, rows: int):
    """(feature columns with the negatives, labels) of `rows` rows on
    `device`."""
    feats, labels = weights.train_columns(cfg, traffic, seed, device, rows)
    g = torch.Generator(device=device).manual_seed(weights.sub_seed(seed, 3))
    vm = cfg["movie_buckets"]
    for k in range(2, traffic["history"] + 1):
        pos = feats[f"userRatedMovie{k}"]
        r = torch.randint(0, vm - 1, pos.shape, generator=g, device=device, dtype=torch.int32)
        feats[f"negativeUserRatedMovie{k}"] = r + (r >= pos).to(torch.int32)
    return feats, labels

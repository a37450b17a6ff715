"""DIN's weights and a training job's columns, made on the device from the
seed in a few large calls.

The weights follow the distributions of the JAX package's initialisers:
tables uniform(-0.05, 0.05), kernels lecun-normal (a normal truncated
to two standard deviations, of variance 1/fan_in), biases and PReLU
slopes zero, except that a configuration's `numeric_scale` divides
fc1's rows for each raw numeric column by that column's typical size
(the untrained tower would otherwise see release years near 2,000 and
give logits near -100, whose probabilities underflow in float32 and tie).
They are keyed by the export's names
(`reference/din.py::param_shapes`), which both the program (through its
export or its `flax_layout`) and the reference read.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference import din as ref
from benchmark.reference.din import param_shapes, truncated_normal

#: lecun_normal's draw in standard units has this standard deviation.
_TRUNC_STD = 0.87962566103423978


def sub_seed(seed: int, stream: int) -> int:
    """A generator seed for one use of the run's seed."""
    return (int(seed) * 0x9E3779B1 + stream * 0x85EBCA77) % (1 << 63)


def make_din(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every DIN parameter, float32 on `device`."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    shapes = param_shapes(cfg["dim"], cfg["hidden"], cfg["attention_hidden"],
                          cfg["user_buckets"], cfg["movie_buckets"])
    tables = [k for k in shapes if k.endswith("/table")]
    kernels = [k for k in shapes if k.endswith("kernel") or k in ("att_w1", "att_w2")]
    out: Dict[str, torch.Tensor] = {}
    sizes = [math.prod(shapes[k]) for k in tables]
    flat = torch.rand(sum(sizes), generator=g, device=device, dtype=torch.float32)
    flat.mul_(0.1).sub_(0.05)
    for k, piece in zip(tables, flat.split(sizes)):
        out[k] = piece.view(shapes[k])
    sizes = [math.prod(shapes[k]) for k in kernels]
    flat = truncated_normal(sum(sizes), g, device)
    for k, piece in zip(kernels, flat.split(sizes)):
        out[k] = piece.view(shapes[k]) * (math.sqrt(1.0 / shapes[k][0]) / _TRUNC_STD)
    scale = cfg.get("numeric_scale")
    if scale:
        # fc1's rows for the raw numeric columns, divided by each column's
        # typical size, so that the untrained tower sees them near 1.
        rows = ref.fc1_numeric_rows(cfg["dim"])
        div = torch.tensor([float(scale[c]) for c in rows], device=device)
        idx = torch.tensor(list(rows.values()), device=device)
        out["fc1/kernel"][idx] /= div[:, None]
    for k, shape in shapes.items():
        if k not in out:
            out[k] = torch.zeros(shape, dtype=torch.float32, device=device)
    return {k: out[k] for k in shapes}


def zipf_ids(n: int, lo: int, hi: int, s: float, g: torch.Generator, device) -> torch.Tensor:
    """n int32 ids in [lo, hi), id lo + r - 1 with probability ~ 1/r^s."""
    ranks = torch.arange(1, hi - lo + 1, device=device, dtype=torch.float64)
    cdf = torch.cumsum(ranks.pow(-s), 0)
    u = torch.rand(n, generator=g, device=device, dtype=torch.float64) * cdf[-1]
    return (lo + torch.searchsorted(cdf, u).clamp_(max=hi - lo - 1)).to(torch.int32)


def train_columns(cfg: dict, traffic: dict, seed: int, device, rows: int):
    """(feature columns, labels) of `rows` rows on `device`: movie ids
    (the candidate and the traffic's `history` slots) Zipf over the movie
    table, user ids uniform, genres uniform over the vocabulary and -1,
    numerics N(0, 1), labels Bernoulli."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    vm, vu = cfg["movie_buckets"], cfg["user_buckets"]
    s = traffic["movie_zipf_s"]
    t = traffic["history"]
    ids = zipf_ids(rows * (t + 1), 1, vm, s, g, device).view(rows, t + 1)
    feats = {"movieId": ids[:, 0].contiguous()}
    for k in range(t):
        feats[f"userRatedMovie{k + 1}"] = ids[:, k + 1].contiguous()
    feats["userId"] = torch.randint(0, vu, (rows,), generator=g, device=device,
                                    dtype=torch.int32)
    for c in ("userGenre1", "movieGenre1"):
        feats[c] = torch.randint(-1, 19, (rows,), generator=g, device=device, dtype=torch.int32)
    for c in ("userRatingCount", "userAvgRating", "userRatingStddev", "releaseYear",
              "movieRatingCount", "movieAvgRating", "movieRatingStddev"):
        feats[c] = torch.randn(rows, generator=g, device=device)
    labels = (torch.rand(rows, generator=g, device=device) < traffic["label_p"]).float()
    return feats, labels

"""DLRM-DCNv2's weights and a training job's columns, made on the device
from the seed in a few large calls.

The weights follow TorchRec's initialisers (as recalled; the
configuration's `assumed`): each table uniform(-a, a), a = sqrt(1 /
rows), from a generator of its own, so that one table can be made again
alone; `nn.Linear` weights and biases uniform(-b, b), b = 1 /
sqrt(fan_in); the cross layers' V and W Xavier-normal, their biases zero.
They are keyed by the program's names (`reference/dlrm_dcnv2.py::
param_shapes`).

The columns: `dense` [rows, 13] standard normals (Criteo's dense features
after the log transform, as the data loader hands them over); for each
feature f, `cat_f` [rows, k_f] int32 ids, Zipf(s) by rank over the rows
held, rank r mapped to a row by a seeded permutation of the table (a
generator a feature); labels Bernoulli(`label_p`).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from benchmark.reference import dlrm_dcnv2 as ref
from benchmark.weights import sub_seed, zipf_ids


def shapes(cfg: dict) -> Dict[str, tuple]:
    return ref.param_shapes(cfg["embedding_dim"], cfg["dense_arch_layer_sizes"],
                            cfg["over_arch_layer_sizes"], cfg["dcn_num_layers"],
                            cfg["dcn_low_rank_dim"], cfg["num_embeddings_per_feature"])


def table_names(cfg: dict) -> List[str]:
    return [f"emb_cat_{f}.table" for f in range(len(cfg["num_embeddings_per_feature"]))]


def make_dense(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter but the tables, float32 on `device`."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    out: Dict[str, torch.Tensor] = {}
    every = shapes(cfg)
    for k, shape in every.items():
        if k.endswith(".table"):
            continue
        if k.startswith("cross.") and k[-1] in "vw":
            std = math.sqrt(2.0 / (shape[0] + shape[1]))
            out[k] = torch.randn(shape, generator=g, device=device) * std
        elif k.startswith("cross."):
            out[k] = torch.zeros(shape, device=device)
        else:
            fan_in = every[k.replace(".bias", ".weight")][1]
            b = 1.0 / math.sqrt(fan_in)
            out[k] = torch.rand(shape, generator=g, device=device).mul_(2 * b).sub_(b)
    return out


def make_table(cfg: dict, seed: int, f: int, device) -> torch.Tensor:
    """Table f, [rows_f, D] float32 on `device`."""
    rows, d = cfg["num_embeddings_per_feature"][f], cfg["embedding_dim"]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 100 + f))
    a = math.sqrt(1.0 / rows)
    return torch.rand((rows, d), generator=g, device=device).mul_(2 * a).sub_(a)


def make_all(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    out = make_dense(cfg, seed, device)
    for f, k in enumerate(table_names(cfg)):
        out[k] = make_table(cfg, seed, f, device)
    return out


def train_columns(cfg: dict, traffic: dict, seed: int, device, rows: int):
    """(feature columns, labels) of `rows` rows on `device`."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    feats = {"dense": torch.randn((rows, ref.DENSE_FEATURES), generator=g, device=device)}
    labels = (torch.rand(rows, generator=g, device=device) < traffic["label_p"]).float()
    for f, (v, k) in enumerate(zip(cfg["num_embeddings_per_feature"], cfg["multi_hot_sizes"])):
        gf = torch.Generator(device=device).manual_seed(sub_seed(seed, 200 + f))
        perm = torch.randperm(v, generator=gf, device=device).to(torch.int32)
        ranks = zipf_ids(rows * k, 0, v, traffic["id_zipf_s"], gf, device)
        feats[f"cat_{f}"] = perm[ranks.long()].view(rows, k)
    return feats, labels

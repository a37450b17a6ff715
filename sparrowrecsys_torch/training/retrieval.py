"""Retrieval training, a two-tower with in-batch softmax negatives: the port
of `sparrowrecsys_tpu/training/retrieval.py`.

Each batch of positive (user, movie) pairs forms a [B, B] logit matrix
(user i x item j); the diagonal is the positive class of a softmax cross
entropy, every other in-batch item a negative. `logq` subtracts
log p(item), the item's frequency among the positive pairs, from each
item's logits (Yi et al. 2019); `l2_normalize` and `temperature` apply at
train time and in `item_matrix`/`user_vectors` alike.

The optimizer is optax's `adam` (eps 1e-8, not the CTR trainer's Keras
1e-7): the port's group-fused Adam (`training/optim.py`), with optax
`adamw`'s decoupled decay `-lr * wd * p` added when `weight_decay` > 0.
Each epoch takes a permutation of the pairs cut to steps x batch; the
orders come from a generator on the device seeded with
`RetrievalConfig.seed`, or injected (`fit_pairs(orders=...)`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from sparrowrecsys_torch.data.dataset import EncodedDataset
from sparrowrecsys_torch.models.features import flax_init
from sparrowrecsys_torch.training.optim import grouped_adam
from sparrowrecsys_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    batch_size: int = 1024
    epochs: int = 20
    learning_rate: float = 1e-3
    seed: int = 0
    #: subtract log p(item) from every logit (sampling-bias correction of
    #: in-batch negatives; without it popular items are down-ranked).
    logq: bool = True
    #: softmax temperature on the dot products (1/T scaling).
    temperature: float = 1.0
    #: L2-normalize tower outputs (cosine retrieval), at train and inference.
    l2_normalize: bool = False
    #: AdamW weight decay (0 = plain Adam).
    weight_decay: float = 0.0


def log_item_frequency(movies: np.ndarray) -> np.ndarray:
    """log(count / n) per movie id (float32), 0 where the id has no pair."""
    counts = np.bincount(movies, minlength=1)
    with np.errstate(divide="ignore"):
        lq = np.log(counts / max(len(movies), 1))
    lq[~np.isfinite(lq)] = 0.0
    return lq.astype(np.float32)


class RetrievalTrainer:
    """Trains a `NeuralCFTwoTower`-style model (with `user_tower` and
    `item_tower` methods) on positive pairs, on `device` (default cuda).
    Params are dicts keyed by `state_dict` name, as `params_from_flax`
    gives them."""

    def __init__(self, model: torch.nn.Module, config: RetrievalConfig = RetrievalConfig(),
                 device=None):
        self.config = config
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.tx = grouped_adam(config.learning_rate, eps=1e-8)

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        if self.config.l2_normalize:
            return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-9)
        return x

    def _load(self, params: Dict[str, torch.Tensor]) -> None:
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(params[name])

    def _params(self) -> Dict[str, torch.Tensor]:
        return {k: p.detach().clone() for k, p in self.model.named_parameters()}

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64)).to(self.device)

    def loss(self, users: torch.Tensor, movies: torch.Tensor, log_q: torch.Tensor):
        """Mean in-batch softmax cross entropy at the model's parameters."""
        uv = self._norm(self.model.user_tower(users))
        iv = self._norm(self.model.item_tower(movies))
        logits = (uv @ iv.T) / self.config.temperature - log_q[None, :]
        return F.cross_entropy(logits, torch.arange(len(users), device=logits.device))

    def fit(self, ds: EncodedDataset, params=None):
        """Train on the positive rows of a CTR dataset. Returns params."""
        pos = ds.labels > 0.5
        return self.fit_pairs(ds.features["userId"][pos], ds.features["movieId"][pos],
                              params=params)

    def fit_pairs(self, users: np.ndarray, movies: np.ndarray, params=None,
                  orders: Optional[Sequence] = None, losses: Optional[list] = None):
        """Train on positive (user, movie) id pairs; returns params.
        `orders[e]`: epoch e's pair order ([steps * batch] indices), e.g.
        `jax.random.permutation(sub, n)[:steps * batch]` of the JAX
        package's key schedule. `losses`: a list that gets each epoch's
        mean loss."""
        cfg = self.config
        users = np.asarray(users, np.int64)
        movies = np.asarray(movies, np.int64)
        n = len(users)
        if n == 0:
            raise ValueError("RetrievalTrainer.fit needs positive (label=1) pairs; "
                             "the dataset has none")
        bs = min(cfg.batch_size, n)
        steps = max(n // bs, 1)
        if params is None:
            params = flax_init(self.model, torch.Generator().manual_seed(cfg.seed))
        self._load(params)
        named = dict(self.model.named_parameters())
        opt_state = self.tx.init(self._params())
        users_d, movies_d = self._ids(users), self._ids(movies)
        log_q_all = (torch.from_numpy(log_item_frequency(movies)).to(self.device)
                     if cfg.logq else None)
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        for epoch in range(cfg.epochs):
            if orders is None:
                order = torch.randperm(n, generator=gen, device=self.device)[: steps * bs]
            else:
                order = self._ids(orders[epoch])
                if order.shape != (steps * bs,):
                    raise ValueError(f"orders[{epoch}] has shape {tuple(order.shape)}, "
                                     f"want ({steps * bs},)")
            u_all = users_d[order].view(steps, bs)
            m_all = movies_d[order].view(steps, bs)
            total = torch.zeros((), device=self.device)
            for s in range(steps):
                lq = (log_q_all[m_all[s]] if log_q_all is not None
                      else torch.zeros(bs, device=self.device))
                self.model.zero_grad(set_to_none=True)
                loss = self.loss(u_all[s], m_all[s], lq)
                loss.backward()
                grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                         for k, p in named.items()}
                updates, opt_state = self.tx.update(grads, opt_state)
                with torch.no_grad():
                    for k, p in named.items():
                        u = updates[k]
                        if cfg.weight_decay:
                            u = u - cfg.learning_rate * cfg.weight_decay * p
                        p.add_(u)
                total += loss.detach()
            if losses is not None:
                losses.append(float(total) / steps)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.model.zero_grad(set_to_none=True)
        return self._params()

    def item_matrix(self, params, n_items: int) -> torch.Tensor:
        """Item ids 0..n_items-1 -> [n, H] for the retrieval index."""
        self._load(params)
        with torch.no_grad():
            return self._norm(self.model.item_tower(
                torch.arange(n_items, device=self.device)))

    def user_vectors(self, params, user_ids) -> torch.Tensor:
        self._load(params)
        with torch.no_grad():
            return self._norm(self.model.user_tower(self._ids(user_ids)))

"""NeuralCF and its two-tower variant: the port of
`sparrowrecsys_tpu/models/neuralcf.py`. Inputs are the movie and user ids
only.

- `NeuralCF`: concat(movie emb, user emb) -> Dense(n, relu) per entry of
  `hidden` -> Dense(1): logits [B].
- `NeuralCFTwoTower`: an MLP over each embedding (`item_tower`,
  `user_tower`, the retrieval plane's encoders), their dot product ->
  Dense(1): logits [B].

Layer names are the flax ones (`interact{i}`, `item{i}`, `user{i}`).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from sparrowrecsys_torch.config import EMBEDDING_DIM, MOVIE_VOCAB_SIZE, USER_VOCAB_SIZE
from sparrowrecsys_torch.models.features import IdEmbed


def _add_mlp(module: nn.Module, prefix: str, widths: Sequence[int], in_dim: int) -> list:
    """Register Linear layers `{prefix}0`, `{prefix}1`, ...; returns their names."""
    names = []
    for i, n in enumerate(widths):
        setattr(module, f"{prefix}{i}", nn.Linear(in_dim, n))
        names.append(f"{prefix}{i}")
        in_dim = n
    return names


def _relu_mlp(module: nn.Module, names: Sequence[str], x: torch.Tensor) -> torch.Tensor:
    for name in names:
        x = torch.relu(getattr(module, name)(x))
    return x


class NeuralCF(nn.Module):
    def __init__(
        self,
        hidden: Sequence[int] = (10, 10),
        dim: int = EMBEDDING_DIM,
        movie_buckets: int = MOVIE_VOCAB_SIZE,
        user_buckets: int = USER_VOCAB_SIZE,
    ):
        super().__init__()
        self.emb_movieId = IdEmbed(movie_buckets, dim)
        self.emb_userId = IdEmbed(user_buckets, dim)
        self._layers = _add_mlp(self, "interact", hidden, 2 * dim)
        self.out = nn.Linear(hidden[-1] if hidden else 2 * dim, 1)

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = torch.cat([self.emb_movieId(features["movieId"]),
                       self.emb_userId(features["userId"])], dim=-1)
        return self.out(_relu_mlp(self, self._layers, x))[..., 0]


class NeuralCFTwoTower(nn.Module):
    def __init__(
        self,
        hidden: Sequence[int] = (10, 10),
        dim: int = EMBEDDING_DIM,
        movie_buckets: int = MOVIE_VOCAB_SIZE,
        user_buckets: int = USER_VOCAB_SIZE,
    ):
        super().__init__()
        self.emb_movieId = IdEmbed(movie_buckets, dim)
        self.emb_userId = IdEmbed(user_buckets, dim)
        self._item = _add_mlp(self, "item", hidden, dim)
        self._user = _add_mlp(self, "user", hidden, dim)
        self.out = nn.Linear(1, 1)

    def item_tower(self, movie_ids: torch.Tensor) -> torch.Tensor:
        return _relu_mlp(self, self._item, self.emb_movieId(movie_ids))

    def user_tower(self, user_ids: torch.Tensor) -> torch.Tensor:
        return _relu_mlp(self, self._user, self.emb_userId(user_ids))

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        item = self.item_tower(features["movieId"])
        user = self.user_tower(features["userId"])
        dot = (item * user).sum(-1, keepdim=True)
        return self.out(dot)[..., 0]

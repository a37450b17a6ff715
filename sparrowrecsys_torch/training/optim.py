"""Group-fused Adam: the port of `sparrowrecsys_tpu/training/optim.py`
(the float32 path).

Adam is elementwise, so concatenating every small float32 leaf into one
vector changes the layout and not the math: one set of Adam ops for the
many tiny tensors of a CTR model, and the large leaves (embedding tables)
per leaf. Parameters, gradients and updates are dicts of tensors keyed by
`state_dict` name.

The updates are bit-equal to the JAX package's (and so to `optax.adam`
with Keras's eps 1e-7 and bias correction by the global count), which
takes two cares:
- XLA's CPU backend contracts each moment update `b*m + (1-b)*g` into one
  fused multiply-add. `_fma` is `torch.add(t, m, alpha=b)`, which rounds
  once as well: its CPU kernel is a vector fused multiply-add, and nvcc
  contracts its CUDA kernel's `a + alpha * b` into one.
- `_sqrt` is the correctly rounded float32 root. The card's `sqrt` is
  (IEEE, as CUDA compiles it without fast math); PyTorch's vectorised
  CPU `sqrt` is not (it can differ in the last bit), so on the CPU
  `_sqrt` takes the float64 root, which rounds to the correct one.
So the card's updates equal the CPU's, in float32 throughout on the card
(`tests/test_torch_kernels.py` checks both bit for bit).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch

#: Leaves with fewer elements ride the fused vector; larger ones (the
#: embedding tables) stay per leaf.
SMALL_LEAF_MAX_ELEMS = 65536


def _f32(x: float) -> float:
    """`x` rounded to float32, as XLA makes a Python float constant."""
    return float(torch.tensor(x, dtype=torch.float32))


def _fma(m: torch.Tensor, beta: float, t: torch.Tensor) -> torch.Tensor:
    """float32 round(m * beta + t), one rounding (beta a float32 value)."""
    return torch.add(t, m, alpha=beta)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def bias_corrections(count: torch.Tensor, b1: float, b2: float):
    """(1 - b1^t, 1 - b2^t) in float32 for the int32 global step t."""
    t = count.float()
    return 1 - b1 ** t, 1 - b2 ** t


def adam_moments(mu, nu, g, b1: float, b2: float):
    """The moment updates, each rounded once as XLA's fused multiply-add."""
    mu = _fma(mu, _f32(b1), (1 - b1) * g)
    nu = _fma(nu, _f32(b2), (1 - b2) * (g * g))
    return mu, nu


def adam_step(mu, nu, c1, c2, learning_rate: float, eps: float) -> torch.Tensor:
    """-lr * (mu / c1) / (sqrt(nu / c2) + eps), float32."""
    return -learning_rate * (mu / c1) / (_sqrt(nu / c2) + eps)


class GroupedAdamState(NamedTuple):
    count: torch.Tensor        # int32 step counter
    mu_vec: torch.Tensor       # first moment, fused small leaves
    nu_vec: torch.Tensor       # second moment, fused small leaves
    mu_big: List[torch.Tensor]  # per-leaf first moments
    nu_big: List[torch.Tensor]  # per-leaf second moments


class GroupedAdam:
    """`init(params) -> state`, `update(grads, state) -> (updates, state)`,
    as the optax transformation; `state` is replaced, never mutated."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, small_max_elems: int = SMALL_LEAF_MAX_ELEMS):
        self.learning_rate, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.small_max_elems = small_max_elems

    def _split(self, tree: Dict[str, torch.Tensor]):
        """Names in order: (small float32 leaves, the rest)."""
        small, big = [], []
        for k, v in tree.items():
            is_small = v.numel() < self.small_max_elems and v.dtype == torch.float32
            (small if is_small else big).append(k)
        return small, big

    @staticmethod
    def _vec(tree, names, like):
        if not names:
            return torch.zeros(0, dtype=torch.float32, device=like.device)
        return torch.cat([tree[k].reshape(-1) for k in names])

    def init(self, params: Dict[str, torch.Tensor]) -> GroupedAdamState:
        small, big = self._split(params)
        like = next(iter(params.values()))
        vec = self._vec(params, small, like)
        return GroupedAdamState(
            count=torch.zeros((), dtype=torch.int32, device=like.device),
            mu_vec=torch.zeros_like(vec), nu_vec=torch.zeros_like(vec),
            mu_big=[torch.zeros_like(params[k]) for k in big],
            nu_big=[torch.zeros_like(params[k]) for k in big],
        )

    def update(self, grads: Dict[str, torch.Tensor], state: GroupedAdamState):
        small, big = self._split(grads)
        like = next(iter(grads.values()))
        count = state.count + 1
        c1, c2 = bias_corrections(count, self.b1, self.b2)

        def one(mu, nu, g):
            mu, nu = adam_moments(mu, nu, g, self.b1, self.b2)
            return mu, nu, adam_step(mu, nu, c1, c2, self.learning_rate, self.eps)

        mu_vec, nu_vec, upd_vec = one(state.mu_vec, state.nu_vec, self._vec(grads, small, like))
        updates = {}
        offset = 0
        for k in small:
            n = grads[k].numel()
            updates[k] = upd_vec[offset:offset + n].view(grads[k].shape)
            offset += n
        mu_big, nu_big = [], []
        for k, mu, nu in zip(big, state.mu_big, state.nu_big):
            m2, n2, updates[k] = one(mu, nu, grads[k])
            mu_big.append(m2)
            nu_big.append(n2)
        updates = {k: updates[k] for k in grads}
        return updates, GroupedAdamState(count, mu_vec, nu_vec, mu_big, nu_big)


def grouped_adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, small_max_elems: int = SMALL_LEAF_MAX_ELEMS) -> GroupedAdam:
    """Group-fused Adam with float32 moments; `optax.adam`'s updates."""
    return GroupedAdam(learning_rate, b1, b2, eps, small_max_elems)

"""Group-fused Adam: the port of `sparrowrecsys_tpu/training/optim.py`.

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

Narrow storage (`TrainConfig.big_moment_dtype`, `bf16_table_params`):
the big leaves' moments may be stored in bfloat16, and a big leaf stored
in bfloat16 keeps a float32 master in the state. The math runs in
float32 either way; the emitted update of a narrow leaf rebases it onto
bf16(master'), so `p + u` rounded to p's dtype (as `optax.apply_updates`
applies it) tracks the master to about one bfloat16 ulp, without the
error compounding.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

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
    #: float32 masters of the big leaves stored narrow: () when
    #: master_weights is off, else a list aligned with the big leaves
    #: (None for a leaf that is float32 already).
    master_big: Any = ()


def split_leaves(tree: Dict[str, torch.Tensor], small_max_elems: int = SMALL_LEAF_MAX_ELEMS,
                 sizes: Optional[Dict[str, int]] = None):
    """Names in the tree's order: (small float32 leaves, which ride the
    fused vector; the rest, per leaf). `sizes` (name -> element count)
    decides in place of the leaves' own sizes: a leaf row-sharded over a
    mesh is split by its whole size, as the JAX package's global
    `x.size` splits it."""
    small, big = [], []
    for k, v in tree.items():
        n = v.numel() if sizes is None else sizes.get(k, v.numel())
        is_small = n < small_max_elems and v.dtype == torch.float32
        (small if is_small else big).append(k)
    return small, big


class GroupedAdam:
    """`init(params) -> state`, `update(grads, state, params=None) ->
    (updates, state)`, as the optax transformation; `state` is replaced,
    never mutated. `params` is needed when a narrow leaf has a master."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, small_max_elems: int = SMALL_LEAF_MAX_ELEMS,
                 big_moment_dtype: Optional[torch.dtype] = None,
                 master_weights: bool = False):
        self.learning_rate, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.small_max_elems = small_max_elems
        self.big_moment_dtype = big_moment_dtype
        self.master_weights = master_weights
        #: The whole leaves' element counts under a mesh (`split_leaves`);
        #: None: each leaf's own.
        self.leaf_sizes: Optional[Dict[str, int]] = None

    def _needs_master(self, leaf: torch.Tensor) -> bool:
        return (self.master_weights and leaf.is_floating_point()
                and leaf.dtype != torch.float32)

    def _moment_zeros(self, leaf: torch.Tensor) -> torch.Tensor:
        if self.big_moment_dtype is not None:
            dtype = self.big_moment_dtype
        else:
            dtype = torch.float32 if self._needs_master(leaf) else leaf.dtype
        return torch.zeros(leaf.shape, dtype=dtype, device=leaf.device)

    @staticmethod
    def _vec(tree, names, like):
        if not names:
            return torch.zeros(0, dtype=torch.float32, device=like.device)
        return torch.cat([tree[k].reshape(-1) for k in names])

    def init(self, params: Dict[str, torch.Tensor]) -> GroupedAdamState:
        small, big = split_leaves(params, self.small_max_elems, self.leaf_sizes)
        like = next(iter(params.values()))
        vec = self._vec(params, small, like)
        masters = ([params[k].float() if self._needs_master(params[k]) else None for k in big]
                   if self.master_weights else ())
        return GroupedAdamState(
            count=torch.zeros((), dtype=torch.int32, device=like.device),
            mu_vec=torch.zeros_like(vec), nu_vec=torch.zeros_like(vec),
            mu_big=[self._moment_zeros(params[k]) for k in big],
            nu_big=[self._moment_zeros(params[k]) for k in big],
            master_big=masters,
        )

    def update(self, grads: Dict[str, torch.Tensor], state: GroupedAdamState,
               params: Optional[Dict[str, torch.Tensor]] = None):
        small, big = split_leaves(grads, self.small_max_elems, self.leaf_sizes)
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
        masters = list(state.master_big) if self.master_weights else [None] * len(big)
        if params is None and any(m is not None for m in masters):
            raise ValueError("grouped_adam(master_weights=True) needs params in update() "
                             "to rebase the narrow copies")
        mu_big, nu_big = [], []
        for j, (k, mu, nu) in enumerate(zip(big, state.mu_big, state.nu_big)):
            g = grads[k]
            if masters[j] is not None:
                # float32 math against the master; the update rebases the
                # narrow param onto bf16(master').
                m2, n2, u32 = one(mu.float(), nu.float(), g.float())
                masters[j] = masters[j] + u32
                p = params[k]
                updates[k] = (masters[j].to(p.dtype).float() - p.float()).to(p.dtype)
            else:
                m2, n2, updates[k] = one(mu.to(g.dtype), nu.to(g.dtype), g)
            if self.big_moment_dtype is not None:
                m2, n2 = m2.to(self.big_moment_dtype), n2.to(self.big_moment_dtype)
            mu_big.append(m2)
            nu_big.append(n2)
        updates = {k: updates[k] for k in grads}
        return updates, GroupedAdamState(count, mu_vec, nu_vec, mu_big, nu_big,
                                         masters if self.master_weights else ())


def grouped_adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, small_max_elems: int = SMALL_LEAF_MAX_ELEMS,
                 big_moment_dtype: Optional[torch.dtype] = None,
                 master_weights: bool = False) -> GroupedAdam:
    """Group-fused Adam; `optax.adam`'s updates. `big_moment_dtype` (e.g.
    torch.bfloat16): storage dtype of the big leaves' moments.
    `master_weights`: a float32 master for each big leaf stored narrow."""
    return GroupedAdam(learning_rate, b1, b2, eps, small_max_elems,
                       big_moment_dtype, master_weights)

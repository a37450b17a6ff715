"""Every collective the port runs, in one place.

A mesh in PyTorch is one process per rank; the ranks of a (data, model)
mesh talk through two process groups, one along each axis
(`parallel/mesh.py::build_mesh`). Each collective here runs on a plain
local tensor over one of them, and is counted: calls and the bytes it
moved, by kind, as the JAX package's `_collective_bytes`
(`__graft_entry__.py:94`) counts them from compiled HLO, the bytes of
each collective's result. There is no HLO to parse here, so the wrapper
adds them up as it runs.

The backend is the default group's, chosen once when it starts
(`parallel/scaling.py::init_distributed`): NCCL when every rank has a
card of its own, gloo otherwise. Gloo takes CUDA tensors as they are
(several ranks sharing one card run over it, `chip_smoke.py` phase 9):
the compute and the buffers stay on the card.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

#: The kinds counted, with the names `_collective_bytes` gives them.
KINDS = ("all-reduce", "all-gather")
#: The axis name of the whole mesh (every rank).
WORLD = "world"


class Collectives:
    """Sum and gather over the mesh's `data` and `model` process groups.

    `groups` maps an axis name (and `WORLD`) to this rank's group along
    it, `sizes` to its number of ranks. Counts live in `calls` and
    `bytes` (by kind) and are reset with `reset_counts`."""

    def __init__(self, groups: Dict[str, "dist.ProcessGroup"], sizes: Dict[str, int]):
        self.groups = dict(groups)
        self.sizes = dict(sizes)
        self.reset_counts()

    def reset_counts(self) -> None:
        self.calls = {k: 0 for k in KINDS}
        self.bytes = {k: 0 for k in KINDS}

    def _count(self, kind: str, nbytes: int) -> None:
        self.calls[kind] += 1
        self.bytes[kind] += nbytes

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum `t` over the group along `axis`, in place; returns `t`."""
        self._count("all-reduce", t.numel() * t.element_size())
        dist.all_reduce(t, group=self.groups[axis])
        return t

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The group's tensors along `axis`, concatenated on dim 0 in the
        order of their coordinates on that axis."""
        n = self.sizes[axis]
        self._count("all-gather", n * t.numel() * t.element_size())
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=self.groups[axis])
        return torch.cat(parts)

    def barrier(self) -> None:
        dist.barrier()

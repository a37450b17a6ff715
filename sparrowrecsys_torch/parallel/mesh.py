"""The (data, model) mesh and the parameter and batch sharding rules: the
port of `sparrowrecsys_tpu/parallel/mesh.py`.

- `data` axis: the batch (data parallel); gradients are summed over it.
- `model` axis: embedding-table rows, the only parameters that grow with
  the vocabulary.

A mesh in PyTorch is one process per rank. The ranks are laid out as
the JAX package lays out its devices (`np.array(devices).reshape(dp,
mp)`), so rank = d * mp + m holds data coordinate d and model coordinate
m. `build_mesh` makes one process group along each axis (the rows and
columns `torch.distributed.device_mesh.init_device_mesh` would make), and
the collectives run on plain local tensors over them
(`parallel/collectives.py`), not through DTensor: the kernels behind
`ops/kernels.py` take raw tensors.

The rules are the JAX package's (`_spec_for`, :77-90), by name and by the
GLOBAL shape: a 2-D leaf whose name ends in `.table` or `.w`, with at
least `min_rows` rows and a row count that divides by n_model, is
row-sharded over `model` (rank m holds rows [m * block, (m + 1) * block));
every other leaf is replicated. A spec is a tuple, as a PartitionSpec
reads: `(model_axis, None)` for a row-sharded leaf, `()` otherwise.

Without a process group `build_mesh` returns a 1x1 plan and every
collective is the identity: the same step runs everywhere.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from sparrowrecsys_torch.config import MeshConfig
from sparrowrecsys_torch.parallel.collectives import WORLD, Collectives


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """This rank's place on an n_data x n_model mesh. `comm` is None on a
    single process (1x1, every collective the identity)."""

    n_data: int = 1
    n_model: int = 1
    rank: int = 0
    data_axis: str = "data"
    model_axis: str = "model"
    comm: Optional[Collectives] = None

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum over `axis` (in place; `WORLD`: every rank); the identity
        without a group."""
        return t if self.comm is None else self.comm.all_reduce(t, axis)

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Concatenate on dim 0 over `axis`; the identity without a group."""
        return t if self.comm is None else self.comm.all_gather(t, axis)

    def barrier(self) -> None:
        if self.comm is not None:
            self.comm.barrier()


def build_mesh(config: Optional[MeshConfig] = None) -> MeshPlan:
    """A (data, model) plan over the ranks of the default process group.

    data_parallel=-1 infers the data size as world / model_parallel. With
    no process group initialised the plan is 1x1 with no collectives
    (a single device, as the JAX package's docstring has it); a
    factorisation that does not match the ranks raises ValueError."""
    import torch.distributed as dist

    config = config or MeshConfig()
    live = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if live else 1
    mp = max(1, config.model_parallel)
    dp = config.data_parallel if config.data_parallel > 0 else n // mp
    if dp * mp != n:
        raise ValueError(f"mesh {dp}x{mp} != {n} devices")
    if not live:
        return MeshPlan(1, 1, 0, config.data_axis, config.model_axis)
    rank = dist.get_rank()
    groups = {}
    # Every rank creates every group, in the same order (new_group's rule).
    for m in range(mp):
        g = dist.new_group([d * mp + m for d in range(dp)])
        if rank % mp == m:
            groups[config.data_axis] = g
    for d in range(dp):
        g = dist.new_group([d * mp + m for m in range(mp)])
        if rank // mp == d:
            groups[config.model_axis] = g
    groups[WORLD] = dist.group.WORLD
    comm = Collectives(groups, {config.data_axis: dp, config.model_axis: mp, WORLD: n})
    return MeshPlan(dp, mp, rank, config.data_axis, config.model_axis, comm)


#: Row-shard embedding tables at or above this many rows; below it the
#: replicated copy costs less than the collectives.
MIN_ROWS_TO_SHARD = 4096


def _spec_for(name: str, shape, plan: MeshPlan, min_rows: int) -> tuple:
    if (name.rpartition(".")[2] in ("table", "w") and len(shape) == 2
            and shape[0] >= min_rows and shape[0] % plan.n_model == 0):
        return (plan.model_axis, None)
    return ()


def param_shardings(params: Dict[str, torch.Tensor], plan: MeshPlan,
                    min_rows: int = MIN_ROWS_TO_SHARD) -> Dict[str, tuple]:
    """{name: spec} for the WHOLE (global) parameters."""
    return {k: _spec_for(k, tuple(v.shape), plan, min_rows) for k, v in params.items()}


def row_block(rows: int, plan: MeshPlan) -> int:
    """Rows per model shard of a `rows`-row leaf (the last one padded)."""
    return -(-rows // plan.n_model)


def shard_params(params: Dict[str, torch.Tensor], plan: MeshPlan,
                 min_rows: int = MIN_ROWS_TO_SHARD,
                 shardings: Optional[Dict[str, tuple]] = None) -> Dict[str, torch.Tensor]:
    """This rank's parameters: the contiguous row block of each row-sharded
    leaf (a view of the whole one), every other leaf as it is."""
    specs = shardings if shardings is not None else param_shardings(params, plan, min_rows)
    out = {}
    for k, v in params.items():
        if specs.get(k):
            block = row_block(v.shape[0], plan)
            v = v[plan.model_index * block:(plan.model_index + 1) * block]
        out[k] = v
    return out


def gather_params(params: Dict[str, torch.Tensor], plan: MeshPlan,
                  shardings: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
    """The whole leaves again, on every rank (for export and comparison):
    each row-sharded leaf gathered over `model` in row order."""
    return {k: plan.all_gather(v, plan.model_axis) if shardings.get(k) else v
            for k, v in params.items()}


def batch_sharding(plan: MeshPlan) -> tuple:
    """The spec of a batch: its rows split over `data`."""
    return (plan.data_axis,)


def shard_batch(batch: Dict[str, torch.Tensor], plan: MeshPlan) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch of [B, ...] arrays: the d-th of
    n_data equal slices (B must divide by n_data)."""
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % plan.n_data:
            raise ValueError(f"batch of {b} rows does not split over {plan.n_data} data ranks")
        per = b // plan.n_data
        out[k] = v[plan.data_index * per:(plan.data_index + 1) * per]
    return out

"""The multi-device plane: the (data, model) mesh, its collectives, and
rank bring-up (the port of `sparrowrecsys_tpu/parallel`)."""

from sparrowrecsys_torch.parallel.mesh import (
    MIN_ROWS_TO_SHARD,
    MeshPlan,
    batch_sharding,
    build_mesh,
    gather_params,
    param_shardings,
    shard_batch,
    shard_params,
)
from sparrowrecsys_torch.parallel.scaling import (
    ScalingPoint,
    host_local_batch,
    init_distributed,
    measure_scaling,
    spawn_ranks,
)

__all__ = [
    "MIN_ROWS_TO_SHARD", "MeshPlan", "ScalingPoint", "batch_sharding", "build_mesh",
    "gather_params", "host_local_batch", "init_distributed", "measure_scaling",
    "param_shardings", "shard_batch", "shard_params", "spawn_ranks",
]

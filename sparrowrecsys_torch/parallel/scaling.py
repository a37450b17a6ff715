"""Process-group bring-up, rank launching and the scaling harness: the
port of `sparrowrecsys_tpu/parallel/scaling.py`.

- `init_distributed(coordinator, num_processes, process_id)` starts the
  default process group (a no-op on one process): NCCL when every rank
  has a card of its own, gloo otherwise, or the backend named.
- `spawn_ranks(fn, mesh, args)` runs `fn(plan, *args)` in one fresh
  process per rank of an n_data x n_model mesh, which meet through a `file://` rendezvous
  in a temporary directory (no TCP port to collide on), each capped at
  one CPU thread, and returns each rank's return value.
- `host_local_batch`: each rank feeds only its own rows.
- `measure_scaling`: the DeepFM train step on 1..N-rank meshes with the
  global batch scaled with the data axis; examples/s and efficiency
  against the one-rank run, for the world sizes that exist (cards for
  `device="cuda"`; processes on the CPU).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


def default_backend(device, world_size: int) -> str:
    """NCCL when the ranks run on cards and each has one of its own, else gloo."""
    if (device is not None and torch.device(device).type == "cuda"
            and torch.cuda.is_available() and torch.cuda.device_count() >= world_size):
        return "nccl"
    return "gloo"


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> None:
    """Start the default process group; a no-op at one process or fewer
    (a NCCL group of world size 1 needs the backend named).

    `coordinator` is an init method (`file:///tmp/x`, `tcp://host:port`).
    `backend` defaults to NCCL when `device` is CUDA and there are at
    least `num_processes` cards, gloo otherwise."""
    import torch.distributed as dist

    if num_processes is None or (num_processes <= 1 and backend is None):
        return
    if backend is None:
        backend = default_backend(device, num_processes)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=coordinator,
                            world_size=num_processes, rank=process_id)


def host_local_batch(local_batch: Dict[str, Any], plan, device=None) -> Dict[str, torch.Tensor]:
    """This rank's own rows as tensors on `device`: each rank feeds only its
    shard of the global batch (the data coordinate's slice), and nothing
    crosses between ranks. All columns must have the same row count."""
    rows = {len(v) for v in local_batch.values()}
    if len(rows) != 1:
        raise ValueError(f"columns of different lengths {sorted(rows)}")
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))).to(device)
            for k, v in local_batch.items()}


# ---- launching ranks ----------------------------------------------------------

def _rank_main(rank: int, fn: Callable, world_size: int, init_method: str, backend: str,
               mesh: tuple, out_dir: str, args: tuple) -> None:
    """One spawned rank: join the group, build the mesh, run `fn`, write
    its result, leave the group."""
    import torch.distributed as dist

    from sparrowrecsys_torch.config import MeshConfig
    from sparrowrecsys_torch.parallel.mesh import build_mesh

    torch.set_num_threads(1)
    init_distributed(init_method, world_size, rank, backend=backend)
    try:
        plan = build_mesh(MeshConfig(data_parallel=mesh[0], model_parallel=mesh[1]))
        result = fn(plan, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        plan.barrier()
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, mesh: Sequence[int], args: tuple = (),
                backend: str = "gloo", timeout: float = 900.0) -> List[Any]:
    """Run `fn(plan, *args)` on each rank of an n_data x n_model mesh, one
    fresh process per rank (spawned, so `fn` and `args` must pickle), and
    return the ranks' results in rank order. A rank's exception is raised
    here with its traceback."""
    import torch.multiprocessing as mp

    world = int(mesh[0]) * int(mesh[1])
    with tempfile.TemporaryDirectory(prefix="ranks") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, init_method, backend, tuple(mesh), tmp, args),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{world} ranks did not finish in {timeout} s")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


# ---- the scaling harness -------------------------------------------------------

@dataclasses.dataclass
class ScalingPoint:
    n_devices: int
    examples_per_sec: float
    efficiency: float


def _vocab(v: int, mp: int) -> int:
    return -(-v // mp) * mp


def _time_steps(plan, per_device_batch: int, steps: int, user_vocab: int,
                movie_vocab: int, device) -> float:
    """Examples/s of `steps` DeepFM train steps on this rank's mesh, the
    global batch per_device_batch x n_data, after 3 warm-up steps."""
    from sparrowrecsys_torch.config import TrainConfig
    from sparrowrecsys_torch.data.synthetic import synthetic_ctr_dataset
    from sparrowrecsys_torch.models import build_model
    from sparrowrecsys_torch.ops import metrics as M
    from sparrowrecsys_torch.parallel.mesh import shard_batch
    from sparrowrecsys_torch.training.loop import Trainer

    mp = plan.n_model
    uv, mv = _vocab(user_vocab, mp), _vocab(movie_vocab, mp)
    batch = per_device_batch * plan.n_data
    trainer = Trainer(build_model("deepfm", user_buckets=uv, movie_buckets=mv),
                      TrainConfig(batch_size=batch, epochs=1), plan=plan, device=device)
    ds = synthetic_ctr_dataset(batch, user_vocab=uv, movie_vocab=mv)
    params, opt_state = trainer.prepare(trainer.init_params())
    local = shard_batch({**ds.features, "__labels__": ds.labels}, plan)
    labels = torch.from_numpy(local.pop("__labels__")).to(trainer.device)
    feats = host_local_batch(local, plan, trainer.device)
    mask = torch.ones_like(labels)
    mstate = M.init_metrics(trainer.device)

    def run(n):
        nonlocal params, opt_state, mstate
        for _ in range(n):
            params, opt_state, mstate = trainer._train_step(
                params, opt_state, mstate, feats, labels, mask)
        trainer._sync()

    run(3)
    plan.barrier()
    t0 = time.perf_counter()
    run(steps)
    plan.barrier()
    return batch * steps / (time.perf_counter() - t0)


def _scaling_rank(plan, per_device_batch, steps, user_vocab, movie_vocab, device):
    if device is not None and torch.device(device).type == "cuda":
        device = torch.device("cuda", plan.rank % torch.cuda.device_count())
    return _time_steps(plan, per_device_batch, steps, user_vocab, movie_vocab, device)


def measure_scaling(
    device_counts: List[int],
    per_device_batch: int = 4096,
    steps: int = 30,
    model_parallel: int = 1,
    user_vocab: int = 30001,
    movie_vocab: int = 1001,
    device=None,
) -> List[ScalingPoint]:
    """One ScalingPoint per world size in `device_counts`, stopping at the
    first that does not exist (more ranks than cards on `cuda`, the
    default). One rank runs in this process; more are spawned
    (`spawn_ranks`, NCCL across cards, gloo on the CPU). The model axis
    is `model_parallel` where it divides the world size, else 1."""
    from sparrowrecsys_torch.config import MeshConfig
    from sparrowrecsys_torch.parallel.mesh import build_mesh
    from sparrowrecsys_torch.utils.device import resolve_device

    dev = resolve_device(device)
    results: List[ScalingPoint] = []
    base = None
    for n in device_counts:
        if dev.type == "cuda" and n > torch.cuda.device_count():
            break
        mp = model_parallel if n % max(model_parallel, 1) == 0 else 1
        if n == 1:
            eps = _time_steps(build_mesh(MeshConfig(data_parallel=1, model_parallel=1)), per_device_batch, steps,
                              user_vocab, movie_vocab, dev)
        else:
            rates = spawn_ranks(_scaling_rank, (n // mp, mp),
                                (per_device_batch, steps, user_vocab, movie_vocab, str(dev)),
                                backend="nccl" if dev.type == "cuda" else "gloo")
            eps = min(rates)
        per_dev = eps / n
        if base is None:
            base = per_dev
        results.append(ScalingPoint(n, eps, per_dev / base))
    return results

"""Process groups, meshes and the parallel train step on torch.distributed
(port of `stf_tpu/parallel/mesh.py`).

Mapping (the JAX package's name -> the port):
    jax.distributed.initialize   -> init_process_group: NCCL (with gloo for
                                    CPU tensors) on the card, gloo on the
                                    CPU (`initialize_distributed`)
    Mesh (data,) / (data, model) -> a DeviceMesh with the same dim names
                                    (`create_mesh`)
    the batch sharded on `data`  -> each rank's rows of the global batch
                                    (`data_parallel_shardings`,
                                    `shard_batch`, `ImageFolder.batches(
                                    shard=...)`)
    jit over the sharded batch   -> DDP over the ranks (`parallelize`),
                                    the metrics averaged over them
                                    (`make_parallel_train_step`)
    tensor_parallel_shardings    -> FSDP2 `fully_shard` on the 2-D mesh
    process_index() == 0, process_count(), sync_global_devices
                                 -> rank 0, the world size, dist.barrier()

A torch rank is a process that takes part in every step, so every rank
takes an equal share of the global batch: the local batch is the global
batch over the world size, and a global batch that does not split into
equal shares raises (JAX instead shrinks its data axis to a divisor of the
batch, leaving devices idle). On a 2-D `(data, model)` mesh every rank
still computes on its own rows; the `model` dim only decides where the
parameters and both Adams' moments live: `fully_shard` on the 2-D mesh
replicates them over `data` and shards them over `model`, on dim 0, which
for a torch conv weight (O, I, kh, kw) and a linear weight (out, in) is
the output-channel axis that `tensor_parallel_shardings` shards in
HWIO / IO. The forward all-gathers them, so B1, GDN and the entropy
models see plain tensors. As in JAX the sharding is layout, not
semantics: the step is the data-parallel step.
"""

import os
from datetime import timedelta
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

# how long a collective may wait for the other ranks before it raises
DEFAULT_TIMEOUT_S = 600


def initialize_distributed(coordinator: Optional[str] = None,
                           device="cuda", backend: Optional[str] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S
                           ) -> torch.device:
    """Join this process to the process group; returns its device.

    The rank and world size come from the environment (`RANK`,
    `WORLD_SIZE`), as `python -m torch.distributed.run` sets them. With
    `coordinator` ("host:port") the group meets at tcp://host:port;
    without, at `env://` (`MASTER_ADDR` / `MASTER_PORT`). The backend is
    NCCL for CUDA tensors with gloo for CPU ones (the checkpointer's
    groups) on a CUDA `device`, and gloo on the CPU. A CUDA rank takes
    card `LOCAL_RANK`; with `backend="gloo"` several ranks may share one
    card (LOCAL_RANK modulo the cards), which NCCL refuses."""
    device = torch.device(device)
    try:
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
    except KeyError as e:
        raise RuntimeError(
            f"initialize_distributed: {e.args[0]} is not set; start the "
            "processes with python -m torch.distributed.run or set RANK "
            "and WORLD_SIZE") from None
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        index = local if "nccl" in backend else local % torch.cuda.device_count()
        torch.cuda.set_device(index)
        device = torch.device("cuda", index)
    init = f"tcp://{coordinator}" if coordinator else "env://"
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    return device


def join_process_group(device, coordinator: Optional[str] = None
                       ) -> torch.device:
    """The trainer CLIs' start-up: join the process group when the
    process was started as one of several ranks (`python -m
    torch.distributed.run` sets WORLD_SIZE) or given a coordinator; a
    group already joined is kept. Returns this rank's device (`device`
    alone when there is no group)."""
    device = torch.device(device)
    if is_initialized():
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if coordinator is None and "WORLD_SIZE" not in os.environ:
        return device
    return initialize_distributed(coordinator, device)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0


def sync_global_devices():
    """Host barrier (reference `dist.barrier()`, `train.py:417`)."""
    if process_count() > 1:
        dist.barrier()


def create_mesh(batch_size: Optional[int] = None, model: int = 1,
                device_type: str = "cuda"):
    """DeviceMesh over every rank: 1-D `("data",)`, or 2-D `("data",
    "model")` when `model` > 1 (parameters and moments sharded over
    `model`, see `parallelize`); the data dim is the world size over
    `model`. Raises ValueError when `model` does not divide the world
    size, or when `batch_size` (the global batch) does not split into
    one equal share a rank."""
    from torch.distributed.device_mesh import init_device_mesh

    world = process_count()
    model = max(int(model), 1)
    data = world // model
    if data < 1 or data * model != world:
        raise ValueError(
            f"a {max(data, 1)}x{model} mesh needs {max(data, 1) * model} "
            f"ranks, have {world}: every rank takes part in each step")
    if batch_size is not None and batch_size % world:
        raise ValueError(
            f"global batch {batch_size} does not split into {world} equal "
            "shares, one a rank (a torch rank cannot sit a step out)")
    if not is_initialized():
        raise RuntimeError("create_mesh needs a process group: call "
                           "initialize_distributed first")
    if model == 1:
        return init_device_mesh(device_type, (data,),
                                mesh_dim_names=("data",))
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


def data_parallel_shardings(mesh) -> Tuple[int, int]:
    """(index, count): this rank's share of the global batch, in
    `ImageFolder.batches(shard=...)`'s and the sampler's terms. Every
    rank of the mesh takes one share."""
    ranks = mesh.mesh.flatten().tolist()
    return ranks.index(dist.get_rank()), len(ranks)


def shard_batch(batch, mesh):
    """This rank's rows of a global batch (a tensor or an array)."""
    index, count = data_parallel_shardings(mesh)
    if len(batch) % count:
        raise ValueError(f"batch of {len(batch)} does not split into "
                         f"{count} equal shares")
    n = len(batch) // count
    return batch[index * n:(index + 1) * n]


def parallelize(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """The model's training forward (`TrainForward`: the forward and the
    aux loss in one call, so that the wrapper sees every use of every
    parameter inside `forward`) made parallel over `mesh`: DDP over the
    ranks, or, on a 2-D mesh, `fully_shard` (replicated over `data`,
    sharded over `model`). The model must already be on its device.

    Build the TrainState after this call: `fully_shard` replaces the
    model's parameters by sharded ones, and the optimizers must hold
    those."""
    from ..training.state import TrainForward

    forward = TrainForward(model)
    if "model" in (mesh.mesh_dim_names or ()) and mesh["model"].size() > 1:
        from torch.distributed.fsdp import fully_shard

        return fully_shard(forward, mesh=mesh)
    from torch.nn.parallel import DistributedDataParallel

    # buffers are constants or functions of the parameters: nothing to
    # broadcast each step
    return DistributedDataParallel(forward, process_group=mesh.get_group(0),
                                   broadcast_buffers=False)


def mean_over_ranks(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each value averaged over every rank, in one all-reduce (gloo has no
    AVG: a sum over the world size)."""
    if process_count() == 1:
        return values
    keys = sorted(values)
    stacked = torch.stack([values[k].detach().double() for k in keys])
    dist.all_reduce(stacked)
    stacked /= process_count()
    return dict(zip(keys, stacked.unbind()))


def make_parallel_train_step(train_step: Callable) -> Callable:
    """`train_step` (`make_train_step` or `make_dytrain_step` of
    `parallelize`'s wrapper: each rank's forward of its rows, one
    backward whose gradients the wrapper averages over the ranks, one
    update) with its metrics averaged over the ranks, i.e. those of the
    global batch."""
    return lambda state, batch: mean_over_ranks(train_step(state, batch))

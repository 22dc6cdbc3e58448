"""Multi-process training on torch.distributed (port of
`stf_tpu/parallel`): process groups, meshes, DDP and sharded state."""

from .mesh import (
    create_mesh,
    data_parallel_shardings,
    initialize_distributed,
    is_initialized,
    is_main_process,
    join_process_group,
    make_parallel_train_step,
    mean_over_ranks,
    parallelize,
    process_count,
    process_index,
    shard_batch,
    sync_global_devices,
)

__all__ = [
    "create_mesh",
    "data_parallel_shardings",
    "initialize_distributed",
    "is_initialized",
    "is_main_process",
    "join_process_group",
    "make_parallel_train_step",
    "mean_over_ranks",
    "parallelize",
    "process_count",
    "process_index",
    "shard_batch",
    "sync_global_devices",
]

"""Multi-device execution: a (data, model) grid of ranks on torch.distributed.

Counterpart of ``dyglib_tpu/parallel/``. One process drives one device
(NCCL between cards, gloo between CPU processes). The data axis splits
every chronological batch by rows, sums gradients, gathers evaluation
probabilities and shards memory-model state by node rows; the model axis
shards feature tables by columns and carries DyGFormer's Ulysses
token/head flip. Every collective goes through ``mesh.py``'s counted
wrappers.
"""
from .distributed import (
    free_port,
    host_batch_slice,
    initialize_distributed,
    process_device,
    shutdown_distributed,
)
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    ColumnShardedTable,
    Mesh,
    all_gather,
    all_reduce,
    all_to_all,
    batch_sharded,
    broadcast,
    collective_counts,
    feature_sharded,
    gather_rows,
    make_mesh,
    replicated,
    reset_collective_counts,
    row_slice,
)

__all__ = [
    "host_batch_slice",
    "initialize_distributed",
    "DATA_AXIS",
    "MODEL_AXIS",
    "batch_sharded",
    "feature_sharded",
    "make_mesh",
    "replicated",
    "free_port",
    "process_device",
    "shutdown_distributed",
    "ColumnShardedTable",
    "Mesh",
    "all_gather",
    "all_reduce",
    "all_to_all",
    "broadcast",
    "collective_counts",
    "gather_rows",
    "reset_collective_counts",
    "row_slice",
]

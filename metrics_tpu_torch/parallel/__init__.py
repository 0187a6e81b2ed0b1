"""Cross-process sync on ``torch.distributed`` (counterpart of ``metrics_tpu/parallel``):
the host sync of ``compute()`` and the collectives over named mesh axes."""
from metrics_tpu_torch.parallel.comm import (
    axis_env,
    class_reduce,
    distributed_available,
    empty_placeholder,
    gather_all_arrays,
    host_reduce,
    mesh_spans_processes,
    process_index,
    reduce,
    reduce_in_trace,
    sync_state_in_trace,
    sync_state_trees,
    world_size,
)

__all__ = [
    "axis_env",
    "class_reduce",
    "distributed_available",
    "empty_placeholder",
    "gather_all_arrays",
    "host_reduce",
    "mesh_spans_processes",
    "process_index",
    "reduce",
    "reduce_in_trace",
    "sync_state_in_trace",
    "sync_state_trees",
    "world_size",
]

"""Cross-process sync on ``torch.distributed`` (counterpart of ``metrics_tpu/parallel``)."""
from metrics_tpu_torch.parallel.comm import (
    class_reduce,
    distributed_available,
    gather_all_arrays,
    host_reduce,
    process_index,
    reduce,
    world_size,
)

__all__ = [
    "class_reduce",
    "distributed_available",
    "gather_all_arrays",
    "host_reduce",
    "process_index",
    "reduce",
    "world_size",
]

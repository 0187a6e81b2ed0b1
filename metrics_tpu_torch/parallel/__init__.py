"""Cross-process sync (counterpart of ``metrics_tpu/parallel``): the host
sync of ``compute()`` over ``torch.distributed`` or over a
:class:`ProcessGroup`'s store exchange, the wire codecs, and the
collectives over named mesh axes.

Wire versions: every store payload rides a versioned crc32 envelope
(:func:`pack_envelope` / :func:`unpack_envelope`). :data:`WIRE_VERSION`
(1) carries exact payloads, the default; :data:`WIRE_VERSION_QUANTIZED` (2)
carries the ``"bf16"`` and ``"int8"`` codecs of
``add_state(sync_precision=)``. :data:`SUPPORTED_WIRE_VERSIONS` is what this
build speaks; the members of a group settle on the highest version they all
speak, and a payload of any other version raises a non-transient
``SyncIntegrityError``.
"""
from metrics_tpu_torch.parallel import comm  # noqa: F401
from metrics_tpu_torch.parallel import quantize  # noqa: F401
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
from metrics_tpu_torch.parallel.groups import (
    SUPPORTED_WIRE_VERSIONS,
    WIRE_VERSION,
    WIRE_VERSION_QUANTIZED,
    ProcessGroup,
    StoreClient,
    gather_group_arrays,
    gather_group_pytrees,
    gather_state_trees,
    negotiation_stats,
    new_group,
    pack_envelope,
    reset_negotiation_stats,
    speaking,
    spoken_wire_versions,
    unpack_envelope,
)
from metrics_tpu_torch.parallel.quantize import CODECS, INT8_BLOCK, reset_wire_stats, wire_stats
from metrics_tpu_torch.resilience.retry import RetryPolicy

__all__ = [
    "CODECS",
    "INT8_BLOCK",
    "SUPPORTED_WIRE_VERSIONS",
    "WIRE_VERSION",
    "WIRE_VERSION_QUANTIZED",
    "ProcessGroup",
    "RetryPolicy",
    "StoreClient",
    "axis_env",
    "class_reduce",
    "comm",
    "distributed_available",
    "empty_placeholder",
    "gather_all_arrays",
    "gather_group_arrays",
    "gather_group_pytrees",
    "gather_state_trees",
    "host_reduce",
    "mesh_spans_processes",
    "negotiation_stats",
    "new_group",
    "pack_envelope",
    "process_index",
    "quantize",
    "reduce",
    "reduce_in_trace",
    "reset_negotiation_stats",
    "reset_wire_stats",
    "speaking",
    "spoken_wire_versions",
    "sync_state_in_trace",
    "sync_state_trees",
    "unpack_envelope",
    "wire_stats",
    "world_size",
]

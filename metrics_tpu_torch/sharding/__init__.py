"""The sharded state plane (counterpart of ``metrics_tpu/sharding``).

* :mod:`~metrics_tpu_torch.sharding.spec`: ``add_state(sharding=)``
  registration, placement over a ``DeviceMesh`` (``Metric.shard_states``)
  and the process-wide telemetry behind ``obs.snapshot()["sharding"]``.
* :mod:`~metrics_tpu_torch.sharding.reduce`: the plumbing of
  ``engine.drive(mesh=, in_specs=)``: batch slices by ``in_specs``, local
  state shards, the data-axis sums.
* :mod:`~metrics_tpu_torch.sharding.linalg`: the Newton–Schulz matrix square
  root and the Fréchet distance from moments, on the device.

The encoder's mesh (``ShardedEncoder(param_specs=, mesh=)``, FID's and
BERTScore's ``encoder_sharding=``) lays parameter leaves out with the same
specs, layouts and gathers (``metrics_tpu_torch/encoders/runtime.py``).
"""
from metrics_tpu_torch.sharding.linalg import (  # noqa: F401
    NEWTON_SCHULZ_FID_RTOL,
    covariance_from_sums,
    fid_from_moments,
    newton_schulz_sqrtm,
)
from metrics_tpu_torch.sharding.reduce import (  # noqa: F401
    build_constraints,
    constrain_state_tree,
    mesh_spans_processes,
    normalize_in_specs,
    stage_epoch_inputs,
    state_shardings_key,
)
from metrics_tpu_torch.sharding.spec import (  # noqa: F401
    PartitionSpec,
    StateSpec,
    canonical_spec,
    class_axis_spec,
    place_states,
    reset_shard_stats,
    shard_stats,
    spec_of_value,
)

__all__ = [
    "NEWTON_SCHULZ_FID_RTOL",
    "PartitionSpec",
    "StateSpec",
    "build_constraints",
    "canonical_spec",
    "class_axis_spec",
    "constrain_state_tree",
    "covariance_from_sums",
    "fid_from_moments",
    "mesh_spans_processes",
    "newton_schulz_sqrtm",
    "normalize_in_specs",
    "place_states",
    "reset_shard_stats",
    "shard_stats",
    "spec_of_value",
    "stage_epoch_inputs",
    "state_shardings_key",
]

"""Resilience layers of the port (counterpart of ``metrics_tpu/resilience``).

* :mod:`~metrics_tpu_torch.resilience.retry`: :class:`RetryPolicy`, the
  per-attempt deadline budgets and the backoff with deterministic jitter of
  a group exchange.
* :mod:`~metrics_tpu_torch.resilience.health`: the numerical-health
  screening of every update (``Metric(on_bad_input=)``).
* :mod:`~metrics_tpu_torch.resilience.faults`: the fault-injection harness:
  an in-memory store with per-(rank, epoch) drop, delay, corrupt and
  straggler faults, per-thread world simulation (:func:`run_as_peers`), and
  the ``METRICS_TPU_FAULTS`` wrapper for live clients.
* :mod:`~metrics_tpu_torch.resilience.integrity`: per-leaf state digests
  and their verification.
* :mod:`~metrics_tpu_torch.resilience.schema`: the durable-schema registry
  (``decode_any``, the downgrade guard, ``compat_stats``).
* :mod:`~metrics_tpu_torch.resilience.overload`: admission control
  (token buckets, the inflight cap, deadline shedding, retry budgets,
  brownout).
* :func:`new_sync_stats`: the counters behind ``Metric.sync_report()``.

The degradation policies (``on_sync_error="raise"|"local"|"partial"``) live
on :class:`~metrics_tpu_torch.metric.Metric`.
"""
from typing import Any, Dict

from metrics_tpu_torch.resilience.faults import (  # noqa: F401
    FAULTS_ENV_VAR,
    FaultPlan,
    FaultSpec,
    FaultyClient,
    InMemoryKVStore,
    InjectedFaultError,
    KVTimeoutError,
    current_client,
    maybe_wrap_client,
    parse_plan,
    plan_from_env,
    run_as_peers,
    simulated_process,
    simulated_world,
)
from metrics_tpu_torch.resilience.integrity import (  # noqa: F401
    fold_digest,
    integrity_stats,
    leaf_digest,
    reset_integrity_stats,
    state_digest,
    verify_tree,
)
from metrics_tpu_torch.resilience.overload import (  # noqa: F401
    AdmissionController,
    TokenBucket,
    overload_summary,
)
from metrics_tpu_torch.resilience.retry import DEFAULT_RETRY, RetryPolicy  # noqa: F401
from metrics_tpu_torch.resilience.schema import (  # noqa: F401
    SchemaVersionError,
    compat_stats,
    current_version,
    decode_any,
    register_schema,
    registered_families,
    registered_versions,
    reset_compat_stats,
)
from metrics_tpu_torch.utils.exceptions import (  # noqa: F401
    OverloadError,
    StateIntegrityError,
    SyncIntegrityError,
    SyncTimeoutError,
)

SYNC_ERROR_POLICIES = ("raise", "local", "partial")

#: The JAX package's sync counters, under the same keys.
_SYNC_STAT_KEYS = (
    "syncs",
    "attempts",
    "retries",
    "kv_timeouts",
    "integrity_failures",
    "barrier_timeouts",
    "degraded_local",
    "degraded_partial",
    "bytes_sent",
    "bytes_received",
    # the wire codecs' bytes before and after encoding (envelope excluded),
    # and the same split over quantized payloads
    "bytes_raw",
    "bytes_encoded",
    "bytes_raw_quantized",
    "bytes_encoded_quantized",
)


def new_sync_stats() -> Dict[str, Any]:
    """Fresh sync counters, the template ``Metric.sync_report()`` reads.

    ``missing_ranks`` and ``last_sync_outcome`` (``"complete"``,
    ``"partial"``, ``"local"``, ``"failed"`` or None) describe the last
    sync; everything else accumulates over the metric's life: ``syncs``,
    ``attempts`` and ``retries`` (peer reads of a group exchange, or one
    attempt per ``torch.distributed`` gather), ``kv_timeouts``,
    ``integrity_failures``, ``barrier_timeouts``, ``backoff_s``,
    ``bytes_sent``/``bytes_received``, ``degraded_local``/
    ``degraded_partial``, and the wire codecs' ``bytes_raw``/
    ``bytes_encoded`` (and their ``*_quantized`` split), per-codec
    ``codec_counts`` and ``max_dequant_error``."""
    from metrics_tpu_torch.parallel.quantize import CODECS

    stats: Dict[str, Any] = {key: 0 for key in _SYNC_STAT_KEYS}
    stats["backoff_s"] = 0.0
    stats["missing_ranks"] = []
    stats["last_sync_outcome"] = None
    stats["codec_counts"] = {codec: 0 for codec in CODECS}
    stats["max_dequant_error"] = 0.0
    return stats

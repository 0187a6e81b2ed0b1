"""Resilience layers of the port (counterpart of ``metrics_tpu/resilience``):
the numerical-health screening, :mod:`~metrics_tpu_torch.resilience.health`,
and the sync telemetry that ``Metric.sync_report()`` reads."""
from typing import Any, Dict

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
    "bytes_raw",
    "bytes_encoded",
    "bytes_raw_quantized",
    "bytes_encoded_quantized",
)

#: The wire codecs of ``add_state(sync_precision=)``; the port syncs exactly.
CODECS = ("exact", "bf16", "int8")


def new_sync_stats() -> Dict[str, Any]:
    """Fresh sync counters, the template ``Metric.sync_report()`` reads.

    The port's sync (``Metric._gather_with_policy`` over
    ``parallel/comm.py`` ``gather_all_arrays``) counts ``syncs`` (one per
    sync of the metric's state), ``attempts`` (one per
    ``gather_all_arrays`` call), ``bytes_sent``/``bytes_received`` of its
    all-gathers (this rank's buffer, the other ranks' buffers),
    ``degraded_local`` and the last sync's ``last_sync_outcome``
    (``"complete"``, ``"local"``, ``"failed"`` or None before the first).
    ``retries``, ``kv_timeouts``, ``integrity_failures``,
    ``barrier_timeouts``, ``degraded_partial``, ``backoff_s``,
    ``missing_ranks`` and the codec counters stay 0 (empty) until the
    deadline-bounded group exchange and the wire codecs are ported
    (ROADMAP §1 item 9)."""
    stats: Dict[str, Any] = {key: 0 for key in _SYNC_STAT_KEYS}
    stats["backoff_s"] = 0.0
    stats["missing_ranks"] = []
    stats["last_sync_outcome"] = None
    stats["codec_counts"] = {codec: 0 for codec in CODECS}
    stats["max_dequant_error"] = 0.0
    return stats

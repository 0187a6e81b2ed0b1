"""Observability (counterpart of ``metrics_tpu/obs``): the event bus,
lifecycle spans, the retrace explainer, the exporters and ``warn_once``.

* :mod:`~metrics_tpu_torch.obs.bus`: a process-wide, locked, bounded, typed
  event stream (captures, cache hits, retraces, bucketing, sync attempts
  and degradations, quarantines, spans, fetches, encoder chunks, kernel
  dispatches, warnings). It ships disabled; the disabled path costs one
  bool read, and enabling it changes no program.
* :mod:`~metrics_tpu_torch.obs.trace`: spans around ``update``,
  ``forward``, ``compute``, ``sync`` and ``drive`` and around the engine's,
  the bank's and the router's dispatch, with an opt-in fence
  (``torch.cuda.synchronize`` of the payload's devices) for device time;
  profiler ranges of them while ``torch.profiler`` records;
  device marks inside the captured programs; counts and samples where work
  waits (``readings()``).
* :mod:`~metrics_tpu_torch.obs.explain`: each retrace names the changed
  program-key component.
* :mod:`~metrics_tpu_torch.obs.export`: ``snapshot()``, JSONL with a
  validated schema, and Prometheus text.
* :mod:`~metrics_tpu_torch.obs.warn`: rank-zero, once-per-key warnings.

Event kinds, explain components, the JSONL schema, the snapshot keys and
the Prometheus family names are the JAX package's.
"""
from metrics_tpu_torch.obs import bus, explain, trace  # noqa: F401
from metrics_tpu_torch.obs.bus import (  # noqa: F401
    EVENT_KINDS,
    Event,
    capture,
    disable,
    emit,
    enable,
    enabled,
    events,
    subscribe,
    unsubscribe,
)
from metrics_tpu_torch.obs.export import (  # noqa: F401
    JSONL_SCHEMA_VERSION,
    process_snapshot,
    prometheus_text,
    snapshot,
    to_jsonl,
    validate_jsonl,
)
from metrics_tpu_torch.obs.trace import (  # noqa: F401
    disable_tracing,
    enable_tracing,
    span,
    span_summary,
    tracing_enabled,
)
from metrics_tpu_torch.obs.warn import (  # noqa: F401
    reset_warn_once,
    warn_counts,
    warn_once,
)

__all__ = [
    "EVENT_KINDS",
    "Event",
    "JSONL_SCHEMA_VERSION",
    "bus",
    "capture",
    "disable",
    "disable_tracing",
    "emit",
    "enable",
    "enable_tracing",
    "enabled",
    "events",
    "explain",
    "process_snapshot",
    "prometheus_text",
    "reset_warn_once",
    "snapshot",
    "span",
    "span_summary",
    "subscribe",
    "to_jsonl",
    "trace",
    "tracing_enabled",
    "unsubscribe",
    "validate_jsonl",
    "warn_counts",
    "warn_once",
]

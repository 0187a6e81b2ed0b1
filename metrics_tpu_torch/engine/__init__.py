"""The update engine (counterpart of ``metrics_tpu/engine``): one update
program per (metric class, configuration, input shapes), shared by every
instance, captured as a CUDA graph on the card and run eagerly on the CPU.

* :mod:`~metrics_tpu_torch.engine.cache`: the shared program cache, the
  fused collection programs and their telemetry.
* :mod:`~metrics_tpu_torch.engine.bucketing`: ``jit_bucket="pow2"`` batch
  padding with the exact row-additive correction.
* :mod:`~metrics_tpu_torch.engine.driver`: :func:`drive` (an epoch in
  K-step program replays), :func:`drive_bank` (one tenant's epoch into
  its serving-bank row in one program) and the async results plane
  (:func:`async_compute`, one coalesced copy per collection).

Introspection: ``Metric.compile_stats()``, :func:`cache_summary`,
:func:`clear_cache`, :func:`fetch_stats`. ``persist`` and ``warmup`` of the
JAX engine are ROADMAP §1 item 10.
"""
from metrics_tpu_torch.engine.bucketing import (  # noqa: F401
    bucket_spec,
    input_spec,
    next_pow2,
    pad_leaves,
    supports_bucketing,
)
from metrics_tpu_torch.engine.cache import (  # noqa: F401
    SharedEntry,
    bank_entry,
    cache_summary,
    clear_cache,
    fused_entry,
    instance_stats,
    metric_fingerprint,
    new_stats,
    program_identity,
    update_transition,
)
from metrics_tpu_torch.engine.driver import (  # noqa: F401
    AsyncResult,
    DriveResult,
    async_compute,
    drive,
    drive_bank,
    fetch_stats,
    reset_fetch_stats,
)

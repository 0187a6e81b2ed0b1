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

* :mod:`~metrics_tpu_torch.engine.persist`: the persistent kernel cache
  (the kernel library built into and loaded from a directory that
  outlives the process; ``METRICS_TPU_COMPILE_CACHE``).
* :mod:`~metrics_tpu_torch.engine.warmup`: warmup manifests (record the
  programs a worker serves; capture them all at the next worker's start;
  ``METRICS_TPU_WARMUP_MANIFEST``). Drive snapshots (``drive(snapshot_store=,
  resume_from=)``, :class:`DriveSnapshot`) live in the driver.

Introspection: ``Metric.compile_stats()``, :func:`cache_summary`,
:func:`clear_cache`, :func:`fetch_stats`, :func:`warmup_report`.
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
from metrics_tpu_torch.engine.persist import (  # noqa: F401
    enable_persistent_cache,
    persistent_cache_enabled,
    persistent_cache_stats,
)
from metrics_tpu_torch.engine import persist as _persist

_persist._maybe_enable_from_env()
from metrics_tpu_torch.engine.driver import (  # noqa: F401, E402
    AsyncResult,
    DriveResult,
    DriveSnapshot,
    async_compute,
    drive,
    drive_bank,
    fetch_stats,
    load_drive_snapshot,
    reset_fetch_stats,
)
from metrics_tpu_torch.engine import warmup as _warmup  # noqa: E402  (the module; ``warmup`` becomes the function)
from metrics_tpu_torch.engine.warmup import (  # noqa: F401, E402
    load_manifest,
    manifest_dict,
    record_manifest,
    save_manifest,
    warmup,
    warmup_report,
)

# the METRICS_TPU_WARMUP_MANIFEST wiring runs at the END of the package's
# import (metrics_tpu_torch/__init__.py): warming unpickles metric templates,
# which imports metric modules

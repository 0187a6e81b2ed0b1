"""Exception types (counterpart of ``metrics_tpu/utils/exceptions.py``)."""


class MetricsUserError(Exception):
    """Error raised by misuse of the metrics API by the user."""


class SyncError(RuntimeError):
    """A cross-process sync failed: a collective raised or timed out.

    ``Metric(on_sync_error="local")`` catches exactly this family when it
    keeps the rank-local state instead of propagating. It subclasses
    ``RuntimeError``, as the errors of ``torch.distributed`` do.
    """


class NumericalHealthError(RuntimeError):
    """A numerical-health policy violation, raised on the host (never inside
    a program): a metric with ``on_bad_input="raise"`` saw a NaN or ±Inf in
    its update inputs (that update is quarantined first, so the accumulated
    state stays clean), or its ``compute()`` result is not finite. The
    message names the metric class, the update index and the NaN and ±Inf
    element counts. A ``RuntimeError``, so the aggregators'
    ``nan_strategy="error"`` callers that catch ``RuntimeError`` still do.
    """


class JitIncompatibleError(ValueError):
    """An update cannot run as a program: it needs a value from the device
    (``.item()``, ``bool()``, a boolean mask), sizes a tensor by the data,
    or its CUDA graph capture was refused. The engine then runs the metric's
    eager update instead; code that calls the pure API inside its own
    program sees it as an error to act on."""

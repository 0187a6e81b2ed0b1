"""Exception types (counterpart of ``metrics_tpu/utils/exceptions.py``)."""


class MetricsUserError(Exception):
    """Error raised by misuse of the metrics API by the user."""


class SyncError(RuntimeError):
    """A cross-process sync failed: a collective raised or timed out.

    ``Metric(on_sync_error="local")`` catches exactly this family when it
    keeps the rank-local state instead of propagating. It subclasses
    ``RuntimeError``, as the errors of ``torch.distributed`` do.
    """

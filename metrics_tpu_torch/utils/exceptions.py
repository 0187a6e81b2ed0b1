"""Exception types raised by the classification slice (counterpart of
``metrics_tpu/utils/exceptions.py``)."""


class MetricsUserError(Exception):
    """Error raised by misuse of the metrics API by the user."""

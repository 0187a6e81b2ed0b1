"""Exception types (counterpart of ``metrics_tpu/utils/exceptions.py``)."""


class MetricsUserError(Exception):
    """Error raised by misuse of the metrics API by the user."""


class SyncError(RuntimeError):
    """A cross-process sync failed: a collective raised or timed out, or a
    group exchange gave up on a peer.

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


class SyncTimeoutError(SyncError):
    """A sync peer's payload (or the group barrier) did not arrive within the
    group deadline, across every attempt the group's
    :class:`~metrics_tpu_torch.resilience.RetryPolicy` allows."""


class SyncIntegrityError(SyncError):
    """A sync payload failed wire-format validation: truncated, checksum
    mismatch, header and body length disagreeing, or a peer speaking another
    wire version.

    ``transient`` marks failures worth a re-read (corruption or truncation
    may be a torn read); a wire-format version mismatch is deterministic and
    is raised with ``transient=False``.
    """

    def __init__(self, message: str, transient: bool = True) -> None:
        super().__init__(message)
        self.transient = transient


class SchemaVersionError(RuntimeError):
    """A durable artifact carries a schema version this build cannot decode:
    one ahead of what it speaks (bytes written by a newer build), or one
    never registered for its family. Old registered versions never raise;
    they decode and walk the upcast chain to current. Distinct from
    :class:`SyncIntegrityError`: the bytes are intact, the build is too old
    or too new to read them. Carries ``family``, ``version`` and
    ``current``.
    """

    def __init__(self, message: str, *, family: object = None, version: object = None, current: object = None) -> None:
        super().__init__(message)
        self.family = family
        self.version = version
        self.current = current


class StateIntegrityError(RuntimeError):
    """Metric state failed attestation: a decoded state tree does not match
    the digest sealed beside it. Unlike :class:`SyncIntegrityError` (bytes
    mangled on the wire, often a torn read worth retrying), re-reading gives
    the same wrong content, so this family is never transient. Carries
    ``bank``, ``tenant`` and ``leaf``.
    """

    def __init__(self, message: str, *, bank: object = None, tenant: object = None, leaf: object = None) -> None:
        super().__init__(message)
        self.bank = bank
        self.tenant = tenant
        self.leaf = leaf


class InjectedFaultError(ConnectionError):
    """A failure injected by a fault plan (``METRICS_TPU_FAULTS``). A
    ``ConnectionError``, so the sync stack classifies it as it would a real
    transport failure: transient, worth another attempt."""


class OverloadError(RuntimeError):
    """A request rejected by admission control, loudly, never dropped in
    silence (:class:`~metrics_tpu_torch.resilience.overload.AdmissionController`):
    over its tenant's quota, past the global inflight cap, unable to meet its
    deadline, or drawing from an exhausted retry budget. ``reason`` names
    the check and ``tenant`` the caller."""

    def __init__(self, message: str, reason: str = "overload", tenant: object = None) -> None:
        super().__init__(message)
        self.reason = reason
        self.tenant = tenant

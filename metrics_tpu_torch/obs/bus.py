"""Process-wide bounded event bus (counterpart of ``metrics_tpu/obs/bus.py``).

The pull reports (``compile_stats()``, ``sync_report()``,
``health_report()``) count after the fact; the bus is the push half. The
engine (captures, cache hits, retraces, bucketing), the sync
(attempts, degradations), the health layer (quarantines), the encoder
stream, the kernel registry and the lifecycle spans emit into it, and the
exporters (``metrics_tpu_torch.obs.export``) write it out as JSONL or
Prometheus text.

* **Disabled is free.** The bus ships disabled; every emit site checks
  :func:`enabled` (one module-level bool) before it builds an event.
* **Enabling changes no program.** Every emit site is host-side Python:
  dispatch bookkeeping, the sync, host checks. An event's data are Python
  values taken from shapes, names and counters, never read from a tensor,
  so a site reached inside a CUDA graph capture (the registry's ``kernel``
  event) records nothing on the card and makes no host sync.
* **Bounded.** Events land in a ring (default 4096 entries,
  ``METRICS_TPU_OBS_CAPACITY``); overflow evicts the oldest and counts it
  in ``dropped``. Per-kind totals survive eviction.
* **Typed.** ``kind`` is one of :data:`EVENT_KINDS`, the JAX package's set
  unchanged, so a JSONL written by either package validates under either.
  The fleet emits ``migrate``, ``fleet_epoch`` and ``upgrade``, its guard
  ``guard`` and ``hedge``.

One process-wide ``RLock`` guards the ring, the counters and the
subscribers; concurrent emitters (``compute_async`` resolving on another
thread) interleave but never tear. Subscribers run synchronously on the
emitting thread; one that raises is counted in ``subscriber_errors`` and
never breaks the emitter.
"""
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

#: The closed set of event kinds (the JSONL schema's ``kind``), as in the
#: JAX package. What the port emits: engine ``compile`` (a capture on the
#: card, a program key's first run on the CPU), ``cache_hit``, ``retrace``
#: (carries the :mod:`~metrics_tpu_torch.obs.explain` verdict) and
#: ``bucketed``; ``encode`` (one streamed encoder chunk); ``sync_attempt``
#: (one ``gather_all_arrays``) and ``sync_degrade`` (a failed sync, kept
#: local or raised); ``quarantine`` (``path`` ``eager``, ``compiled`` or
#: ``pre_encode``); the spans ``update``/``forward``/``compute``/``sync``/
#: ``drive``; ``fetch`` (an ``AsyncResult`` resolved); ``warning`` (a
#: ``warn_once`` emission); ``kernel`` (one registry dispatch that Python
#: ran: ``op``, ``path`` ``cuda`` or ``plain``, ``reason``).
EVENT_KINDS = (
    "compile",
    "cache_hit",
    "retrace",
    "bucketed",
    "encode",
    "sync_attempt",
    "sync_retry",
    "sync_degrade",
    "wire",
    "quarantine",
    "update",
    "forward",
    "compute",
    "sync",
    "drive",
    "fetch",
    "reshard",
    "admit",
    "evict",
    "flush",
    "bank_drive",
    "journal",
    "spill_write",
    "recover",
    "snapshot",
    "migrate",
    "fleet_epoch",
    "guard",
    "shed",
    "hedge",
    "warmup",
    "warmup_stale",
    "attest",
    "audit",
    "repair",
    "compat",
    "upgrade",
    "warning",
    "kernel",
)

_DEFAULT_CAPACITY = 4096


def _capacity_from_env() -> int:
    try:
        return max(16, int(os.environ.get("METRICS_TPU_OBS_CAPACITY", _DEFAULT_CAPACITY)))
    except ValueError:
        return _DEFAULT_CAPACITY


class Event:
    """One event: ``kind`` (see :data:`EVENT_KINDS`), a process-wide
    increasing ``seq``, wall-clock ``t`` (``time.time()``), ``source`` (the
    emitting component, usually a metric class name) and a flat JSON-safe
    ``data`` payload."""

    __slots__ = ("kind", "seq", "t", "source", "data")

    def __init__(self, kind: str, seq: int, t: float, source: str, data: Dict[str, Any]) -> None:
        self.kind = kind
        self.seq = seq
        self.t = t
        self.source = source
        self.data = data

    def as_dict(self) -> Dict[str, Any]:
        """The JSONL wire form (schema version 1)."""
        return {"v": 1, "seq": self.seq, "kind": self.kind, "t": self.t, "source": self.source, "data": self.data}

    def __repr__(self) -> str:
        return f"Event(kind={self.kind!r}, seq={self.seq}, source={self.source!r}, data={self.data!r})"


# emit sites read this before doing any work: the disabled path is one
# attribute load and a truth test
_ENABLED = False

_LOCK = threading.RLock()
_BUFFER: "deque[Event]" = deque(maxlen=_capacity_from_env())
_SEQ = 0
_DROPPED = 0
_SUBSCRIBER_ERRORS = 0
_COUNTS: Dict[str, int] = {}
_SUBSCRIBERS: List[Callable[[Event], None]] = []


def enabled() -> bool:
    """Whether the bus is recording (the hot-path guard)."""
    return _ENABLED


def enable() -> None:
    """Start recording (idempotent). No program changes."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    """Stop recording (idempotent). The buffer is kept; :func:`clear` drops it."""
    global _ENABLED
    _ENABLED = False


def emit(kind: str, source: str = "", **data: Any) -> Optional[Event]:
    """Record one event; returns it, or ``None`` while the bus is disabled.
    An unknown ``kind`` raises ``ValueError``. Hot-path sites check
    :func:`enabled` before building ``data``."""
    global _SEQ, _DROPPED, _SUBSCRIBER_ERRORS
    if not _ENABLED:
        return None
    if kind not in EVENT_KINDS:
        raise ValueError(f"Unknown obs event kind {kind!r}; must be one of {EVENT_KINDS}")
    with _LOCK:
        _SEQ += 1
        event = Event(kind, _SEQ, time.time(), source, data)
        if len(_BUFFER) == _BUFFER.maxlen:
            _DROPPED += 1
        _BUFFER.append(event)
        _COUNTS[kind] = _COUNTS.get(kind, 0) + 1
        subscribers = list(_SUBSCRIBERS)
    for fn in subscribers:
        try:
            fn(event)
        except Exception:  # noqa: BLE001 - a subscriber never breaks the emitter
            with _LOCK:
                _SUBSCRIBER_ERRORS += 1
    return event


def subscribe(fn: Callable[[Event], None]) -> Callable[[Event], None]:
    """Register a synchronous per-event callback; returns ``fn`` (usable as
    a decorator). What it raises is counted, not raised."""
    with _LOCK:
        _SUBSCRIBERS.append(fn)
    return fn


def unsubscribe(fn: Callable[[Event], None]) -> None:
    with _LOCK:
        try:
            _SUBSCRIBERS.remove(fn)
        except ValueError:
            pass


def events(kind: Optional[str] = None) -> List[Event]:
    """The buffered events, oldest first, optionally of one kind."""
    with _LOCK:
        snap = list(_BUFFER)
    if kind is None:
        return snap
    return [e for e in snap if e.kind == kind]


def clear() -> None:
    """Drop the buffered events and zero the counters (the enabled flag and
    the subscribers stay)."""
    global _DROPPED, _SUBSCRIBER_ERRORS
    with _LOCK:
        _BUFFER.clear()
        _COUNTS.clear()
        _DROPPED = 0
        _SUBSCRIBER_ERRORS = 0


def capacity() -> int:
    return _BUFFER.maxlen or 0


def set_capacity(n: int) -> None:
    """Resize the ring (keeps the newest events that fit; at least 16)."""
    global _BUFFER
    with _LOCK:
        _BUFFER = deque(_BUFFER, maxlen=max(16, int(n)))


def summary() -> Dict[str, Any]:
    """The bus's counters: the section ``obs.snapshot()`` embeds."""
    with _LOCK:
        counts = dict(_COUNTS)
        return {
            "enabled": _ENABLED,
            "capacity": _BUFFER.maxlen,
            "buffered": len(_BUFFER),
            "emitted_total": sum(counts.values()),
            "dropped": _DROPPED,
            "subscriber_errors": _SUBSCRIBER_ERRORS,
            "by_kind": counts,
        }


class capture:
    """``with obs.bus.capture() as events: ...`` enables the bus for the
    block, collects the events emitted in it (of ``kinds`` only, when
    given) and restores the previous enabled flag on exit. The process
    buffer still receives them."""

    def __init__(self, kinds: Optional[Tuple[str, ...]] = None) -> None:
        self._kinds = kinds
        self._events: List[Event] = []
        self._was_enabled = False

    def _on_event(self, event: Event) -> None:
        if self._kinds is None or event.kind in self._kinds:
            self._events.append(event)

    def __enter__(self) -> List[Event]:
        self._was_enabled = _ENABLED
        enable()
        subscribe(self._on_event)
        return self._events

    def __exit__(self, *exc: Any) -> None:
        unsubscribe(self._on_event)
        if not self._was_enabled:
            disable()

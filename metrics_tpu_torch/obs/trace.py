"""Lifecycle spans: wall time per metric phase (counterpart of
``metrics_tpu/obs/trace.py``).

A span wraps one phase (``update``, ``forward``, ``compute``, ``sync``,
``drive``), records its wall time into per-(phase, source) aggregates
(count, total, min, max) and, while the bus records, emits one event of the
phase's kind.

* **Unfenced (default):** the span measures host time. CUDA work is
  asynchronous, so an update span that replays a graph ends once the
  replay is enqueued; the span adds no host sync.
* **Fenced (``enable_tracing(fence=True)``):** before reading the clock the
  span synchronizes every CUDA device that holds a tensor of the payload
  the site hands it (``torch.cuda.synchronize(device)``, the whole device:
  the engine may replay on another stream than the caller's current one,
  so a per-stream wait could miss the work). One device sync per span: a
  profiling mode. On the CPU the fence is a no-op that still reports
  ``fenced=True``, as ``jax.block_until_ready`` does on CPU arrays.

Instrumented sites call :func:`active` (two module-bool reads) and enter
the span only when something listens, so a disabled run builds no span
object. Nothing here runs inside a program.
"""
import threading
import time
from typing import Any, Callable, Dict, Optional

from metrics_tpu_torch.obs import bus as _bus

_TRACING = False
_FENCE = False

_LOCK = threading.RLock()
#: (phase, source) -> {"count", "total_s", "min_s", "max_s", "fenced"}
_AGG: Dict[Any, Dict[str, Any]] = {}


def tracing_enabled() -> bool:
    return _TRACING


def fence_enabled() -> bool:
    return _FENCE


def enable_tracing(fence: bool = False) -> None:
    """Start recording spans; ``fence=True`` makes each span wait for the
    devices its payload lives on (see the module doc)."""
    global _TRACING, _FENCE
    _TRACING = True
    _FENCE = bool(fence)


def disable_tracing() -> None:
    global _TRACING, _FENCE
    _TRACING = False
    _FENCE = False


def active() -> bool:
    """True when spans are taken at all: tracing aggregates them or the bus
    streams them. The guard every instrumented site checks first."""
    return _TRACING or _bus.enabled()


def clear() -> None:
    """Drop the span aggregates (the tracing and fence flags stay)."""
    with _LOCK:
        _AGG.clear()


def span_summary() -> Dict[str, Dict[str, Any]]:
    """``{phase: {source: aggregate}}`` of every span since the last
    :func:`clear`: ``count``, ``total_s``, ``mean_s``, ``min_s``, ``max_s``
    and whether any of them was ``fenced``."""
    out: Dict[str, Dict[str, Any]] = {}
    with _LOCK:
        items = [(k, dict(v)) for k, v in _AGG.items()]
    for (phase, source), entry in items:
        entry["mean_s"] = entry["total_s"] / entry["count"] if entry["count"] else 0.0
        out.setdefault(phase, {})[source] = entry
    return out


def _record(phase: str, source: str, elapsed_s: float, fenced: bool) -> None:
    with _LOCK:
        agg = _AGG.get((phase, source))
        if agg is None:
            _AGG[(phase, source)] = {
                "count": 1,
                "total_s": elapsed_s,
                "min_s": elapsed_s,
                "max_s": elapsed_s,
                "fenced": fenced,
            }
            return
        agg["count"] += 1
        agg["total_s"] += elapsed_s
        agg["min_s"] = min(agg["min_s"], elapsed_s)
        agg["max_s"] = max(agg["max_s"], elapsed_s)
        agg["fenced"] = agg["fenced"] or fenced


def _cuda_devices(tree: Any, out: set) -> None:
    if isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    elif getattr(tree, "is_cuda", False):
        out.add(tree.device)


def fence(payload: Any) -> None:
    """Wait for every CUDA device that holds a tensor of ``payload`` (a
    tensor or a nest of dicts, lists and tuples); nothing on the CPU."""
    devices: set = set()
    _cuda_devices(payload, devices)
    if devices:
        import torch

        for device in devices:
            torch.cuda.synchronize(device)


class span:
    """Context manager timing one lifecycle phase.

    Args:
        phase: the phase, a kind of :data:`~metrics_tpu_torch.obs.bus.EVENT_KINDS`
            (the finished span is emitted as an event of that kind).
        source: the emitting component, usually a metric class name.
        payload: zero-arg callable returning the tensors to fence on (the
            site's state after the phase); called only when fencing.
        fence: ``None`` follows :func:`enable_tracing`; a bool forces it.

    A span exits cleanly on an exception too; its event then carries
    ``error=True`` and it is not fenced.
    """

    __slots__ = ("phase", "source", "payload", "fence", "_t0")

    def __init__(
        self,
        phase: str,
        source: str = "",
        payload: Optional[Callable[[], Any]] = None,
        fence: Optional[bool] = None,
    ) -> None:
        self.phase = phase
        self.source = source
        self.payload = payload
        self.fence = _FENCE if fence is None else fence
        self._t0 = 0.0

    def __enter__(self) -> "span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> None:
        fenced = False
        if self.fence and self.payload is not None and exc_type is None:
            try:
                fence(self.payload())
                fenced = True
            except Exception:  # noqa: BLE001 - timing never masks the work's own error
                pass
        elapsed = time.perf_counter() - self._t0
        if _TRACING:
            _record(self.phase, self.source, elapsed, fenced)
        if _bus.enabled():
            data: Dict[str, Any] = {"duration_s": elapsed, "fenced": fenced}
            if exc_type is not None:
                data["error"] = True
            _bus.emit(self.phase, source=self.source, **data)

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

**On the profiler's clock.** While ``torch.profiler`` records, a span also
enters a profiler range named ``metrics_tpu_torch.<phase>:<source>``, so it
shares the device trace's clock, and the trace can put the device's idle
gaps down to the port's own code. The range is the ``RecordFunction`` that
``record_function`` wraps, entered directly: ``record_function`` adds two
dispatched operations of its own to each range, which the profiler records
too. Phases beyond the bus's :data:`~metrics_tpu_torch.obs.bus.EVENT_KINDS`
(the engine's ``engine.key``, ``engine.copy_in``, ``engine.replay`` and
``engine.clone_out``, the bank's ``bank.prepare``, ``bank.dispatch`` and
``bank.write_back``, the router's ``router.flush``) feed the range and the
aggregate, and emit no event.

Instrumented sites call :func:`active` (three module-bool reads: tracing,
the bus, the profiler) and enter the span only when something listens, so a
disabled run builds no span object and no string.

**Device marks.** A replayed CUDA graph runs no Python, so no host range can
see what its parts cost on the device. :func:`mark` launches a one-thread
no-op kernel, ``metrics_tpu_torch_mark<stage>`` (``csrc/mark.cu``), at a
boundary of a program the engine runs: ``format`` where the classification
input formatter starts, ``update`` where it returns (the stat-score and
confusion update follow), ``end`` at the end of each forward or update
program, ``wave`` and ``wave_end`` around a bank wave (whose per-request
transitions mark nothing: see :func:`quiet_marks`). The marks are captured
into the graphs set-up builds, so a traced replay runs the very program an
untraced one does; they sync nothing, are not counted as kernel launches,
and are no-ops on the CPU and outside the engine's programs.

**Counts and samples.** Where work happens behind a queue, the sites keep
counts (:func:`count`) and bounded reservoirs of samples (:func:`sample`)
while :func:`active`: the router's wait of each request from ``submit`` to
its wave's flush, the bank's rows launched and pow2 pad rows.
:func:`readings` reads them.
"""
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

from metrics_tpu_torch.obs import bus as _bus
from metrics_tpu_torch.utils.program import in_program

_TRACING = False
_FENCE = False

_LOCK = threading.RLock()
#: (phase, source) -> {"count", "total_s", "min_s", "max_s", "fenced"}
_AGG: Dict[Any, Dict[str, Any]] = {}
#: name -> count, and name -> [samples seen, reservoir], since the last clear()
_COUNTS: Dict[str, int] = {}
_SAMPLES: Dict[str, List[Any]] = {}
#: Samples a reservoir keeps of each name; past it, a uniform draw of them.
SAMPLE_CAPACITY = 4096
_RNG = random.Random(0)

RANGE_PREFIX = "metrics_tpu_torch."
_EVENT_KINDS = frozenset(_bus.EVENT_KINDS)

#: The stages a device mark names, in ``csrc/mark.cu``'s order.
MARK_STAGES = ("format", "update", "end", "wave", "wave_end")
_STAGE_CODES = {stage: i for i, stage in enumerate(MARK_STAGES)}
_QUIET = threading.local()

#: The range a span enters while the profiler records.
_Range = torch._C._profiler._RecordFunctionFast


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
    """True when spans are taken at all: tracing aggregates them, the bus
    streams them or ``torch.profiler`` records their ranges. The guard
    every instrumented site checks first."""
    return _TRACING or _bus.enabled() or _profiler._is_profiler_enabled


def clear() -> None:
    """Drop the span aggregates, the counts and the samples (the tracing
    and fence flags stay)."""
    with _LOCK:
        _AGG.clear()
        _COUNTS.clear()
        _SAMPLES.clear()


def count(name: str, n: int) -> None:
    """Add ``n`` to the count ``name``. Sites call it only while :func:`active`."""
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def sample(name: str, value: float) -> None:
    """Keep ``value`` in the reservoir ``name``: the first
    :data:`SAMPLE_CAPACITY` samples, then each later one in place of a
    kept one with the chance that keeps the reservoir a uniform draw of
    every sample seen. Sites call it only while :func:`active`."""
    with _LOCK:
        entry = _SAMPLES.setdefault(name, [0, []])
        entry[0] += 1
        kept = entry[1]
        if len(kept) < SAMPLE_CAPACITY:
            kept.append(value)
        else:
            j = _RNG.randrange(entry[0])
            if j < SAMPLE_CAPACITY:
                kept[j] = value


def readings() -> Dict[str, Dict[str, Any]]:
    """The counts and samples since the last :func:`clear`:
    ``{"counts": {name: n}, "samples": {name: [value, ...]}}``. Kept:
    ``bank.rows_launched`` and ``bank.rows_padded`` (a wave's requests with
    its pow2 pad requests, and the pad requests alone), and
    ``router.queue_wait_ms`` (each request's wait from ``submit`` to the
    start of its wave's flush, on the router's clock)."""
    with _LOCK:
        return {"counts": dict(_COUNTS), "samples": {name: list(kept) for name, (_, kept) in _SAMPLES.items()}}


def mark(stage: str, like: Any) -> None:
    """Launch the device mark of ``stage`` (one of :data:`MARK_STAGES`) on
    the current stream of the device ``like`` lives on: a tensor, or a nest
    of dicts, lists and tuples whose first tensor decides. Only inside an
    engine program (``utils.program.in_program``) outside
    :func:`quiet_marks`; a no-op on the CPU."""
    if in_program() and not getattr(_QUIET, "depth", 0):
        _launch_mark(_STAGE_CODES[stage], like)


def _first_tensor(tree: Any) -> Any:
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return tree if hasattr(tree, "is_cuda") else None
    for v in tree:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def _launch_mark(stage: int, like: Any) -> None:
    t = _first_tensor(like)
    if t is None or not t.is_cuda:
        return
    from metrics_tpu_torch.ops import _build

    lib = _build.library()
    err = lib.mt_mark(t.device.index, stage, torch.cuda.current_stream(t.device).cuda_stream)
    _build.check(lib, err, "device mark")


class quiet_marks:
    """Within it, :func:`mark` launches nothing on this thread: the
    per-request transitions of a bank wave, an epoch's steps and bootstrap
    replicates, whose marks would cost a kernel node each per request."""

    __slots__ = ()

    def __enter__(self) -> None:
        _QUIET.depth = getattr(_QUIET, "depth", 0) + 1

    def __exit__(self, *exc: Any) -> None:
        _QUIET.depth -= 1


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
        for device in devices:
            torch.cuda.synchronize(device)


class span:
    """Context manager timing one lifecycle phase.

    Args:
        phase: the phase; one that is a kind of
            :data:`~metrics_tpu_torch.obs.bus.EVENT_KINDS` is emitted as an
            event of that kind once the span finishes.
        source: the emitting component, usually a metric class name.
        payload: zero-arg callable returning the tensors to fence on (the
            site's state after the phase); called only when fencing.
        fence: ``None`` follows :func:`enable_tracing`; a bool forces it.

    A span exits cleanly on an exception too; its event then carries
    ``error=True`` and it is not fenced.
    """

    __slots__ = ("phase", "source", "payload", "fence", "_t0", "_range")

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
        self._range: Any = None

    def __enter__(self) -> "span":
        if _profiler._is_profiler_enabled:
            self._range = _Range(f"{RANGE_PREFIX}{self.phase}:{self.source}")
            self._range.__enter__()
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
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        if _TRACING:
            _record(self.phase, self.source, elapsed, fenced)
        if _bus.enabled() and self.phase in _EVENT_KINDS:
            data: Dict[str, Any] = {"duration_s": elapsed, "fenced": fenced}
            if exc_type is not None:
                data["error"] = True
            _bus.emit(self.phase, source=self.source, **data)

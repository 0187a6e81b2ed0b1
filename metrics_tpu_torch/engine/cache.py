"""Process-wide cache of metric update programs (counterpart of
``metrics_tpu/engine/cache.py``).

The JAX engine turns ``update`` into a pure transition ``state, inputs ->
state`` and compiles it with ``jax.jit``. The port keeps exactly that pure
transition (``resilience/health.traced_update``) as one Python function and
runs it two ways:

* **On the CPU** it runs eagerly, under the in-program flag and its
  host-sync guard (``utils/program.py``). That is what the tests hold
  against the JAX package.
* **On CUDA** it is captured once per program key into a
  ``torch.cuda.CUDAGraph`` and replayed.

**Shared entries.** Programs are cached under ``(kind, fingerprint)``. The
fingerprint holds everything that can change the program: the class, the
public configuration (simple values by value, tensors by content digest,
other objects by pinned identity), the non-state buffers by content, and the
state spec (names, dtypes, shapes, default contents, reductions). Under one
entry a program key adds the variant and the inputs: each tensor's shape,
dtype and device, and each non-tensor input by value (a CUDA graph bakes a
Python scalar in, where ``jax.jit`` traces it). Every instance and clone
with the same fingerprint shares the entry and its graphs.

**What capture needs, in place of donation.** ``jax.jit`` can donate the
state buffers and accumulate in place; a CUDA graph instead reads and writes
fixed addresses. So a program owns *static* buffers: a copy of every input
tensor (states and batch), made at capture, and the graph's output tensors,
allocated from one memory pool shared by every program of the process
(``torch.cuda.graph_pool_handle()``). A replay copies the caller's state and
batch into the static inputs (``torch._foreach_copy_``), replays, and
**clones the outputs**: the metric's state tensors are always fresh tensors
of its own, never the graph's. That is the choice this module makes against
aliasing: a state snapshot (``forward``'s, ``sync``'s, a user's reference)
never changes under a later replay, and states stay "replaced, never
written in place", on both devices. ``set_donation``, ``guard_donated_state``
and ``rollback_state`` have no counterpart: nothing a program is given is
ever consumed. A graph also reads tensors it was not given (a metric's
defaults in the bucketing correction, a threshold buffer); the program keeps
references to every tensor of the capturing instances, so they outlive it.

**Warm-up and the Python-init probe.** A metric whose update is served by a
replay never runs its Python ``update`` body, so attributes it sets
(``Accuracy.mode``) would be skipped. Each instance's first dispatch
therefore runs the transition eagerly (on the card, on a side stream): the
probe. When the program key has no graph yet, that run is also the warm-up
(the kernels' ``.so`` is built and loaded at first use) and the capture
follows. (A bank program's probe runs the wave's first request alone, then
replays the wave.) An operation the program cannot hold raises
:class:`~metrics_tpu_torch.utils.exceptions.JitIncompatibleError` (the guard,
or a capture the toolkit refused), and the caller falls back to the eager
update, as a failed trace does in JAX; a refused capture is remembered, so
other instances go eager at once.

**Launch counts.** A kernel wrapper counts its launches in Python, which a
replay does not run: the capture records the registry launches it saw
(``ops/registry.recording``) and every replay credits them.

**Telemetry.** Each entry counts calls, ``compiles`` (captures on the card;
first runs of a program key on the CPU), cache hits, retraces (programs
beyond a variant's first) and bucketed calls; the same deltas go to the
calling instance's ``compile_stats()``. :func:`cache_summary` aggregates.
While the event bus records, the host-side counting after each dispatch
(never the captured transition) emits ``compile``, ``cache_hit`` or
``retrace``; a retrace carries the explainer's verdict
(``obs/explain.py``), from signatures built only while the bus is on.

**Bootstrap entries.** ``BootStrapper``'s multinomial fast path advances
its ``B`` replicates in one program (:func:`bootstrap_transition`): the
JAX package vmaps the template's transition over a leading ``[B]`` axis;
here the program loops over the replicates, since the kernel wrappers are
ctypes launches with no batching rule.

**Bank entries.** A serving bank's wave (:func:`bank_entry`,
:func:`collection_bank_entry`) and its per-tenant epoch
(:func:`bank_drive_entry`) are programs over the bank's leaves, which are
*resident*: the bank is the carry of a long-lived serving loop, so its
leaves are fixed tensors the program reads in place (``invoke(resident=)``),
never copied in. Only the slot ids and the requests' inputs are static
inputs. The requests of a wave run one after another in the program, as
the bootstrap replicates do, and the program returns the wave's new rows
without writing them: the bank writes them back (``index_copy_``) once the
wave succeeded, on a pod bank once every process of its mesh agreed. The
rows are the graph's own outputs, not cloned: the bank reads them before
the program's next replay, under its lock. Everything that hands a row to
a caller (``MetricBank.tenant_state``, exports, checkpoints, audits,
``compute_async``) takes a copy of it. A graph bakes the leaves' addresses
in, so on the card it belongs to its bank: it is kept on the
:class:`Resident` leaves, in a memory pool of their own, and goes with the
bank. A wave's warm-up runs one request and returns nothing, so a refused
capture leaves the bank as it was.

**Encoder entries.** An encoder's forward (:func:`encoder_entry`, kind
``encode``) is a program like an update: one per input signature, shared by
every :class:`~metrics_tpu_torch.encoders.ShardedEncoder` with the same
apply callable, parameter signature, specs and mesh (the parameters are
runtime data).
Its ``encode_acc`` variant runs the forward and a consumer in one graph.
cuDNN is captured with ``cudnn.benchmark`` off and TF32 off, in the warm-up
as in the capture, and a refused capture raises: an encoder never falls
back to an eager forward in silence.

**Warm programs** (``engine/warmup.py``). :meth:`SharedEntry.warm` runs a
recorded program key ahead of its first dispatch: the capture on the card,
the first eager run on the CPU. The key is marked warmed, so a later
dispatch that finds it counts a ``warmed_hit``; a new key in a variant the
manifest covered is a stale manifest (``warmup.note_stale``, the explainer
naming what changed). While a manifest records, every successful dispatch
is recorded (``warmup.record_dispatch``). All of it sits behind one module
flag, ``_WARM_HOOKS``: with no manifest loaded or recording, a dispatch
pays one boolean read for it.

The mesh-aware driver entries (``drive(mesh=)``) live with the rest of the
driver's programs in ``engine/driver.py``; ``axis_world`` is re-exported
here, where the JAX engine keeps it.
"""
import contextlib
import hashlib
import importlib
import threading
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.engine import _tree, bucketing
from metrics_tpu_torch.obs import bus as _bus
from metrics_tpu_torch.obs import explain as _explain
from metrics_tpu_torch.obs import trace as _trace
from metrics_tpu_torch.ops import registry as _kernels
from metrics_tpu_torch.parallel.comm import axis_world  # noqa: F401  (the JAX engine's home of it)
from metrics_tpu_torch.resilience import health as _health
from metrics_tpu_torch.utils.exceptions import JitIncompatibleError
from metrics_tpu_torch.utils.program import program_scope

#: Entries pin configuration objects and hold graphs and their buffers, so
#: the cache is bounded; the least recently used entry goes first.
MAX_ENTRIES = 512

_CACHE: "OrderedDict[Any, SharedEntry]" = OrderedDict()
_LOCK = threading.RLock()
_POOLS: Dict[int, Any] = {}
_SIDE_STREAMS: Dict[int, Any] = {}

#: The JAX package's per-instance keys; ``donated_bytes`` stays 0 (nothing
#: a program is given is consumed).
_STAT_KEYS = ("compiles", "cache_hits", "retraces", "donated_bytes", "bucketed_calls")

#: Errors after which a metric runs its eager update instead of a program:
#: the JAX engine's trace errors, as this package raises them.
FALLBACK_ERRORS = (JitIncompatibleError, NotImplementedError, TypeError)

#: Whether the warmup layer watches dispatches (a manifest loaded or
#: recording): the one flag a dispatch reads when it does not.
_WARM_HOOKS = False


def set_warm_hooks(on: bool) -> None:
    global _WARM_HOOKS
    _WARM_HOOKS = bool(on)


def new_stats() -> Dict[str, int]:
    return {k: 0 for k in _STAT_KEYS}


def instance_stats(obj: Any) -> Dict[str, int]:
    stats = obj.__dict__.get("_compile_stats")
    if stats is None:
        stats = new_stats()
        obj._compile_stats = stats
    return stats


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------
_SIMPLE = (str, int, float, bool, bytes, type(None))

# Lifecycle machinery bound per instance, and the host-level sync
# configuration: it steers compute-time gathers outside every program, and
# keying on it (ids, for callables) would give each instance with its own
# sync callable a private program.
_FP_SKIP = frozenset(
    (
        "update",
        "compute",
        "forward",
        "reset",
        "training",
        "compute_on_step",
        "dist_sync_on_step",
        "process_group",
        "dist_sync_fn",
        "on_sync_error",
        "axis_name",
    )
)


def _digest(x: torch.Tensor) -> Tuple:
    a = x.detach().cpu().contiguous().numpy()
    return ("tensor", str(x.dtype), tuple(x.shape), hashlib.sha1(a.tobytes()).hexdigest())


def _attr_token(value: Any, pins: List[Any]) -> Tuple:
    if isinstance(value, torch.Tensor):
        return _digest(value)
    if isinstance(value, np.ndarray):
        return ("array", value.dtype.str, value.shape, hashlib.sha1(value.tobytes()).hexdigest())
    if isinstance(value, _SIMPLE):
        return ("val", type(value).__name__, repr(value))
    if isinstance(value, (tuple, list)) and all(isinstance(x, _SIMPLE) for x in value):
        return ("seq", type(value).__name__, repr(value))
    # callables, sub-metrics, other objects: by identity, and pinned so the
    # id cannot be recycled under the key
    pins.append(value)
    return ("id", id(value))


def program_identity(metric: Any) -> Tuple[Any, Tuple]:
    """Which program serves ``metric``: its fingerprint. Whose state is an
    argument of every dispatch, never part of the program."""
    return metric_fingerprint(metric)


def metric_fingerprint(metric: Any) -> Tuple[Any, Tuple]:
    """``(key, pins)`` for one instance, computed at its first dispatch and
    kept: the configuration is frozen once the instance has dispatched
    (build a new metric to change it)."""
    cached = metric.__dict__.get("_engine_key")
    if cached is not None:
        return cached, metric.__dict__.get("_engine_key_pins", ())
    pins: List[Any] = []
    cfg = tuple(
        (name, _attr_token(metric.__dict__[name], pins))
        for name in sorted(metric.__dict__)
        if not name.startswith("_") and name not in metric._defaults and name not in _FP_SKIP
    )
    buffers = tuple(
        (name, _digest(buf))
        for name, buf in sorted(metric._buffers.items())
        if name not in metric._defaults and buf is not None
    )
    state_spec = []
    for name, default in metric._defaults.items():
        fx = metric._reductions[name]
        fx_token = fx if (fx is None or isinstance(fx, str)) else _attr_token(fx, pins)
        if isinstance(default, list):
            state_spec.append((name, "list", fx_token))
        else:
            state_spec.append((name, _digest(default), fx_token))
    # a placed state's window is baked into the program (the class-windowed
    # kernels take its offset as an argument), so the layout keys it
    layouts = metric.__dict__.get("_shard_layout") or {}
    placement = tuple(sorted((n, l.global_shape, l.offsets, l.local_shape) for n, l in layouts.items()))
    key = (type(metric), cfg, buffers, tuple(state_spec), placement)
    metric._engine_key = key
    metric._engine_key_pins = tuple(pins)
    # what the instance had learned when it was keyed (usually nothing yet):
    # a warmup manifest's digest and templates key as the instance did
    metric._engine_key_dyn = {a: metric.__dict__.get(a) for a in getattr(metric, "_dynamic_state_attrs", ())}
    return key, tuple(pins)


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------
def _static_token(x: Any) -> Any:
    try:
        hash(x)
        return ("v", type(x).__name__, x)
    except TypeError:
        return ("id", id(x))


def _program_key(variant: str, leaves: List[Any], spec: Any) -> Tuple:
    sig = tuple(
        (tuple(x.shape), x.dtype, x.device) if isinstance(x, torch.Tensor) else _static_token(x) for x in leaves
    )
    return (variant, spec, sig)


def _cells(cell: Any) -> List[Any]:
    return list(cell) if isinstance(cell, (list, tuple)) else [cell]


def _instance_tensors(cell: Any) -> List[torch.Tensor]:
    """Every tensor the capturing instances hold (defaults, buffers,
    attributes): a graph may read any of them by address."""
    out: List[torch.Tensor] = []
    for m in _cells(cell):
        if not isinstance(m, torch.nn.Module):  # an encoder: its graph pins its apply callable
            continue
        for mod in m.modules():
            out.extend(d for d in mod.__dict__.get("_defaults", {}).values() if isinstance(d, torch.Tensor))
            out.extend(b for b in mod._buffers.values() if b is not None)
            out.extend(v for v in mod.__dict__.values() if isinstance(v, torch.Tensor))
            for delta in mod.__dict__.get("_zero_row_deltas", {}).values():
                out.extend(delta.values())
    return out


def _pool(device: torch.device) -> Any:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _POOLS:
        _POOLS[idx] = torch.cuda.graph_pool_handle()
    return _POOLS[idx]


def _end_refused_capture(device: torch.device, stream: Any, pool: Any) -> None:
    """Leave a refused capture into ``pool`` behind. When an operation
    invalidates a capture, ``torch.cuda.graph`` raises from
    ``cudaStreamEndCapture`` before it ends the allocators' recording to the
    pool and before it puts the caller's stream back: the pool stays
    recording (every later capture into it fails with "beginAllocateToPool:
    already recording to mempool_id"), the caching allocator holds freed
    blocks for a capture that never ends, and later work runs on the capture
    stream. So: end the caching allocator's recording where one is left (a
    capture that ended cleanly left none, and the call raises) and restore
    ``stream``. Later captures take a fresh pool (the engine's shared pool
    is replaced here, a bank's own is dropped by the caller); the graphs
    captured before keep theirs."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    end = getattr(torch._C, "_cuda_endAllocateToPool", None)
    if end is not None:
        try:
            end(idx, pool)
        except RuntimeError:
            pass
    torch.cuda.set_stream(stream)
    if _POOLS.get(idx) == pool:
        _POOLS[idx] = torch.cuda.graph_pool_handle()


def _side_stream(device: torch.device) -> Any:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SIDE_STREAMS:
        _SIDE_STREAMS[idx] = torch.cuda.Stream(device=idx)
    return _SIDE_STREAMS[idx]


class Resident(dict):
    """A bank's resident leaves (state name -> tensor, one row per slot on
    the leading axis), and on the card the programs captured over them with
    their memory pool. A graph bakes the leaves' addresses in, so no other
    bank can replay it: the programs are the bank's, and dropping the bank
    frees them and, once its last graph is gone, their pool. ``layout`` is
    the bank's placement on a mesh (tenant axes, shard count, this
    process's shard; ``((), 1, 0)`` off a mesh), which keys its programs."""

    def __init__(self, leaves: Dict[str, torch.Tensor], layout: Tuple = ((), 1, 0)) -> None:
        super().__init__(leaves)
        self.layout = layout
        self.programs: Dict[Tuple, Any] = {}
        self.pool: Any = None

    def graph_pool(self) -> Any:
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        return self.pool


def _resident_key(resident: Any) -> Tuple:
    """A bank program's resident leaves in its key: names, shapes, dtypes
    and devices, and on the card their addresses (a graph bakes them in),
    with the bank's layout."""
    return (getattr(resident, "layout", None),) + tuple(
        (n, tuple(t.shape), t.dtype, t.device, t.data_ptr() if t.is_cuda else None) for n, t in sorted(resident.items())
    )


def _clone_all(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    out = [torch.empty_like(t) for t in tensors]
    if out:
        torch._foreach_copy_(out, tensors)
    return out


class _Graph:
    """One captured program: the graph, its static input and output tensors,
    the registry launches its capture recorded, and the tensors it reads
    by address. ``resident`` tensors (a bank's leaves) are not copied in:
    the graph reads them at their own addresses, which key it, and its
    outputs (the wave's new rows) are handed out uncloned: the bank reads
    them before the next replay."""

    __slots__ = (
        "graph", "static_in", "tensor_pos", "out_leaves", "out_spec", "launches", "pins", "nbytes", "resident", "kind"
    )

    def __init__(
        self,
        fn: Callable,
        cell: Any,
        leaves: List[Any],
        spec: Any,
        pool: Any,
        resident: Optional[Resident],
        kind: str,
    ) -> None:
        self.kind = kind
        static = [x.clone() if isinstance(x, torch.Tensor) else x for x in leaves]
        self.tensor_pos = [i for i, x in enumerate(static) if isinstance(x, torch.Tensor)]
        self.static_in = [static[i] for i in self.tensor_pos]
        self.pins = _instance_tensors(cell)
        self.graph = torch.cuda.CUDAGraph()
        head = () if resident is None else (resident,)
        with _kernels.recording() as launches:
            with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
                with program_scope():
                    out = fn(cell, *head, *_tree.unflatten(spec, static))
        self.launches = launches
        self.out_leaves, self.out_spec = _tree.flatten(out)
        self.nbytes = sum(t.numel() * t.element_size() for t in self.static_in)
        self.resident = resident is not None

    def replay(self, leaves: List[Any]) -> Any:
        if _trace.active():
            return self._replay_traced(leaves)
        torch._foreach_copy_(self.static_in, [leaves[i] for i in self.tensor_pos])
        self.graph.replay()
        _kernels.credit(self.launches)
        return self._outputs()

    def _replay_traced(self, leaves: List[Any]) -> Any:
        with _trace.span("engine.copy_in", self.kind):
            torch._foreach_copy_(self.static_in, [leaves[i] for i in self.tensor_pos])
        with _trace.span("engine.replay", self.kind):
            self.graph.replay()
        _kernels.credit(self.launches)
        if self.resident:
            return self._outputs()
        with _trace.span("engine.clone_out", self.kind):
            return self._outputs()

    def _outputs(self) -> Any:
        """The graph's outputs: its own on resident leaves, else fresh clones."""
        if self.resident:
            return _tree.unflatten(self.out_spec, self.out_leaves)
        tensors = [x for x in self.out_leaves if isinstance(x, torch.Tensor)]
        fresh = iter(_clone_all(tensors))
        return _tree.unflatten(
            self.out_spec, [next(fresh) if isinstance(x, torch.Tensor) else x for x in self.out_leaves]
        )


_FAILED = "capture refused"


class SharedEntry:
    """One family of programs (its variants and input signatures) shared by
    every instance with the same fingerprint."""

    def __init__(self, key: Any, kind: str, pins: Tuple = ()) -> None:
        self.key = key
        self.kind = kind
        self.calls = 0
        self.traces = 0
        self.cache_hits = 0
        self.bucketed_calls = 0
        self._variant_traces: Dict[str, int] = {}
        self._programs: Dict[Tuple, Any] = {}
        self._fns: Dict[str, Callable] = {}
        self._pins = pins
        self._lock = threading.RLock()
        # the last dispatch signature per variant, for the retrace explainer
        self._obs_sigs: Dict[str, Dict[str, Any]] = {}
        # the live banks whose programs this entry captured on the card, by
        # id (a dict of tensors neither hashes nor compares by identity)
        self._residents: "weakref.WeakValueDictionary[int, Resident]" = weakref.WeakValueDictionary()
        # warmup manifests: the program keys warmed ahead of their first
        # dispatch, and per variant the signatures a manifest covered
        self._warm: set = set()
        self._warm_covered: Dict[str, List[Dict[str, Any]]] = {}

    @property
    def retraces(self) -> int:
        return sum(max(0, n - 1) for n in self._variant_traces.values())

    def _all_programs(self) -> List[Any]:
        """This entry's programs: its own, and those it captured over the
        leaves of banks that are still alive."""
        out = list(self._programs.values())
        for resident in list(self._residents.values()):
            out.extend(p for k, p in list(resident.programs.items()) if k[0] == self.kind)
        return out

    @property
    def graphs(self) -> List[_Graph]:
        return [p for p in self._all_programs() if isinstance(p, _Graph)]

    def invoke(
        self,
        variant: str,
        cell: Any,
        stats: Optional[Dict[str, int]],
        *inputs: Any,
        probe: bool = False,
        bucket: Optional[int] = None,
        resident: Optional[Resident] = None,
    ) -> Any:
        """Run one variant on ``inputs``: a replay of its graph on the card
        (captured at the key's first call, after an eager warm-up on a side
        stream), the eager transition on the CPU. ``probe`` makes an
        instance's first dispatch run the Python body even where a graph
        exists; ``bucket`` (the padded batch of a bucketed dispatch) goes
        into the explainer's signature. ``resident`` (a bank's leaves) is
        passed to the body before ``inputs`` and is read in place, never
        copied; on the card its programs are kept on it.
        Raises :class:`JitIncompatibleError` where the program cannot be
        captured."""
        if _trace.active():
            with _trace.span("engine.key", self.kind):
                fn, leaves, spec, key, device, head, programs = self._resolve(variant, inputs, resident)
        else:
            fn, leaves, spec, key, device, head, programs = self._resolve(variant, inputs, resident)
        program = programs.get(key)
        if program == _FAILED:
            raise JitIncompatibleError(f"the {self.kind} program {variant!r} could not be captured on {device}")
        new = program is None
        if device.type != "cuda":
            with program_scope():
                out = fn(cell, *head, *inputs)
            if new:
                programs[key] = True
        elif new:
            out = self._capture(variant, fn, cell, inputs, leaves, spec, device, programs, key, resident)
        elif probe and resident is None:
            with program_scope():
                out = fn(cell, *head, *inputs)
        elif probe:
            # a bank's cell probes on the wave's first request alone (it
            # writes nothing), and the graph replays the wave
            with program_scope():
                fn(cell, *head, *inputs, warm_up=True)
            out = program.replay(leaves)
        else:
            out = program.replay(leaves)
        self._count(variant, new, stats)
        if _bus.enabled():
            self._emit_dispatch(variant, new, cell, leaves, bucket)
        if _WARM_HOOKS:
            self._warm_hooks(variant, key, new, cell, inputs, leaves, bucket, resident)
        return out

    def _resolve(self, variant: str, inputs: Tuple, resident: Optional[Resident]) -> Tuple:
        """``(fn, leaves, spec, key, device, head, programs)`` of one
        dispatch: its program key, and the dict its program lives in (a
        bank's own on the card)."""
        fn = self._fns[variant]
        leaves, spec = _tree.flatten(inputs)
        key = _program_key(variant, leaves, spec)
        device = next((x.device for x in leaves if isinstance(x, torch.Tensor)), torch.device("cpu"))
        head: Tuple = ()
        programs = self._programs
        if resident is not None:
            key = key + (_resident_key(resident),)
            head = (resident,)
            if device.type == "cuda":
                key = (self.kind,) + key
                programs = resident.programs
                self._residents[id(resident)] = resident
        return fn, leaves, spec, key, device, head, programs

    def warm(
        self,
        variant: str,
        cell: Any,
        *inputs: Any,
        resident: Optional[Resident] = None,
        check: Optional[Callable[[], Optional[str]]] = None,
    ) -> bool:
        """Make the program of ``inputs``' key before its first dispatch
        (``engine/warmup.py``): the warm-up and the capture on the card, the
        first eager run on the CPU, counted as the entry's compile. A
        bank's warm-up request runs with ``warm_up=True`` and writes no
        row. ``check`` (after the run) names what went wrong, or None: a
        program it refuses is dropped and ``ValueError`` raised. Marks the
        key warmed; returns whether it was not before. Raises where the
        program cannot be made."""
        fn, leaves, spec, key, device, head, programs = self._resolve(variant, inputs, resident)
        program = programs.get(key)
        if program == _FAILED:
            raise JitIncompatibleError(f"the {self.kind} program {variant!r} could not be captured on {device}")
        if program is None:
            if device.type != "cuda":
                with program_scope():
                    fn(cell, *head, *inputs)
                programs[key] = True
            else:
                self._capture(variant, fn, cell, inputs, leaves, spec, device, programs, key, resident)
            problem = check() if check is not None else None
            if problem is not None:
                programs.pop(key, None)
                raise ValueError(problem)
            with self._lock:
                self._variant_traces[variant] = self._variant_traces.get(variant, 0) + 1
                self.traces += 1
        fresh = key not in self._warm
        self._warm.add(key)
        return fresh

    def _warm_hooks(
        self,
        variant: str,
        key: Tuple,
        new: bool,
        cell: Any,
        inputs: Tuple,
        leaves: List[Any],
        bucket: Optional[int],
        resident: Optional[Resident],
    ) -> None:
        """A dispatch seen by the warmup layer: a warmed program found
        counts a warmed hit, a new program in a covered variant is a stale
        manifest, and a recording manifest records it."""
        wm = importlib.import_module("metrics_tpu_torch.engine.warmup")
        if not new and key in self._warm:
            wm.count_warm_hit()
        elif new and variant in self._warm_covered:
            source, screening = self._obs_context(cell)
            wm.note_stale(self, variant, _explain.signature(leaves, bucket=bucket, screening=screening), source)
        if wm.recording():
            try:
                wm.record_dispatch(self, variant, cell, inputs, bucket, resident)
            except Exception:  # noqa: BLE001 — recording must never break serving
                pass

    def _capture(
        self,
        variant: str,
        fn: Callable,
        cell: Any,
        inputs: Tuple,
        leaves: List[Any],
        spec: Any,
        device: torch.device,
        programs: Dict[Tuple, Any],
        key: Tuple,
        resident: Optional[Resident],
    ) -> Any:
        """Warm up, capture and keep the program of ``key``; returns the
        warm-up's output. A bank program's warm-up (``warm_up=True``) runs
        its first request alone and writes nothing to the bank; the first
        replay then applies the whole wave, so a refused capture leaves the
        bank as it was."""
        if resident is None:
            out = self._warm_up(fn, cell, inputs, device)
            pool = _pool(device)
        else:
            self._warm_up(fn, cell, (resident,) + inputs, device, warm_up=True)
            pool = resident.graph_pool()
        with self._lock:
            stream = torch.cuda.current_stream(device)
            try:
                programs[key] = _Graph(fn, cell, leaves, spec, pool, resident, self.kind)
            except (JitIncompatibleError, RuntimeError) as err:  # RuntimeError: the toolkit refused an operation
                programs[key] = _FAILED
                _end_refused_capture(device, stream, pool)
                if resident is not None:
                    resident.pool = None
                if isinstance(err, JitIncompatibleError):
                    raise
                raise JitIncompatibleError(f"CUDA graph capture of {self.kind} {variant!r} failed: {err}") from err
        if resident is None:
            return out
        return programs[key].replay(leaves)

    @staticmethod
    def _warm_up(fn: Callable, cell: Any, inputs: Tuple, device: torch.device, **kwargs: Any) -> Any:
        side = _side_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side), program_scope():
            out = fn(cell, *inputs, **kwargs)
        torch.cuda.current_stream(device).wait_stream(side)
        return out

    def _count(self, variant: str, new: bool, stats: Optional[Dict[str, int]]) -> None:
        with self._lock:
            self.calls += 1
            bucketed = variant.startswith("bucketed")
            self.bucketed_calls += bucketed
            if new:
                before = self._variant_traces.get(variant, 0)
                self._variant_traces[variant] = before + 1
                self.traces += 1
            else:
                self.cache_hits += 1
        if stats is not None:
            stats["bucketed_calls"] += bucketed
            if new:
                stats["compiles"] += 1
                stats["retraces"] += before > 0
            else:
                stats["cache_hits"] += 1

    def _obs_context(self, cell: Any) -> Tuple[str, Tuple]:
        """The events' ``source`` and the signature's ``screening``, by
        entry kind: one metric instance as the cell (its class; its health
        policy, screen and bucketing), an encoder (its name; screening
        happens upstream of it), or a member list (the kind; each member's
        class and policy)."""
        if self.kind in ("metric_update", "bootstrap_update", "bank_update", "bank_drive"):
            return type(cell).__name__, (
                getattr(cell, "on_bad_input", "propagate"),
                getattr(cell, "health_screen", "nonfinite"),
                getattr(cell, "jit_bucket", None),
            )
        if self.kind == "encode":
            return getattr(cell, "name", None) or type(cell).__name__, ()
        return self.kind, tuple((type(m).__name__, getattr(m, "on_bad_input", "propagate")) for m in _cells(cell))

    def _emit_dispatch(self, variant: str, new: bool, cell: Any, leaves: List[Any], bucket: Optional[int]) -> None:
        """``cache_hit``, ``compile`` or ``retrace`` for one dispatch (the
        bus known on). Shapes, dtypes and Python values only: nothing reads
        a tensor."""
        source, screening = self._obs_context(cell)
        if not new:
            _bus.emit("cache_hit", source=source, entry_kind=self.kind, variant=variant)
            return
        sig = _explain.signature(leaves, bucket=bucket, screening=screening)
        with self._lock:
            is_retrace = self._variant_traces.get(variant, 0) > 1
            explanation = _explain.record_and_explain(self._obs_sigs, variant, sig, is_retrace)
        if is_retrace:
            _bus.emit("retrace", source=source, entry_kind=self.kind, variant=variant, traces=1, explain=explanation)
        else:
            _bus.emit("compile", source=source, entry_kind=self.kind, variant=variant, traces=1)

    def summary(self) -> Dict[str, Any]:
        graphs = self.graphs
        return {
            "kind": self.kind,
            "calls": self.calls,
            "compiles": self.traces,
            "cache_hits": self.cache_hits,
            "retraces": self.retraces,
            "bucketed_calls": self.bucketed_calls,
            "graphs": len(graphs),
            "failed_captures": sum(p == _FAILED for p in self._all_programs()),
            "static_bytes": sum(g.nbytes for g in graphs),
            "warmed_programs": len(self._warm),
        }


def _get_or_create(cache_key: Any, factory: Callable[[], SharedEntry]) -> SharedEntry:
    with _LOCK:
        entry = _CACHE.get(cache_key)
        if entry is None:
            entry = factory()
            _CACHE[cache_key] = entry
        _CACHE.move_to_end(cache_key)
        while len(_CACHE) > MAX_ENTRIES:
            _CACHE.popitem(last=False)
        return entry


# ---------------------------------------------------------------------------
# single-metric update programs
# ---------------------------------------------------------------------------
def _make_metric_entry(key: Any, pins: Tuple) -> SharedEntry:
    entry = SharedEntry(key, "metric_update", pins)

    def _exact(inst, state, args, kwargs):
        out = _health.traced_update(inst, state, args, kwargs)
        _trace.mark("end", state)
        return out

    def _bucketed(inst, state, args, kwargs, pad_count):
        out = _health.traced_update(inst, state, args, kwargs, pad_count=pad_count)
        _trace.mark("end", state)
        return out

    entry._fns = {"exact": _exact, "bucketed": _bucketed}
    return entry


def probed(metrics: Any) -> bool:
    """Whether every instance has run its Python-init probe."""
    return all(m.__dict__.get("_engine_probed", False) for m in _cells(metrics))


def mark_probed(metrics: Any) -> None:
    for m in _cells(metrics):
        m._engine_probed = True


def pad_count_tensor(pad: int, device: torch.device) -> torch.Tensor:
    """The pad row count as a device scalar (a fill, not a host copy)."""
    return torch.full((), pad, dtype=torch.int64, device=device)


def update_transition(
    metric: Any, state: Dict[str, Any], args: Tuple[Any, ...], kwargs: Dict[str, Any]
) -> Dict[str, Any]:
    """Dispatch one metric update through the shared cache. Raises whatever
    the program raises; ``Metric._update_impl`` owns the fallback."""
    key, pins = metric_fingerprint(metric)
    entry = _get_or_create(("metric_update", key), lambda: _make_metric_entry(key, pins))
    stats = instance_stats(metric)
    probe = not probed(metric)
    spec = bucketing.bucket_spec(metric, args, kwargs)
    if spec is None:
        out = entry.invoke("exact", metric, stats, state, args, kwargs, probe=probe)
    else:
        leaves, treedef, batched, pad = spec
        batch = int(leaves[batched[0]].shape[0])
        if _bus.enabled():
            bucketing.emit_bucket_event(type(metric).__name__, batch, pad)
        padded_args, padded_kwargs = _tree.unflatten(treedef, bucketing.pad_leaves(leaves, batched, pad))
        device = leaves[batched[0]].device
        out = entry.invoke(
            "bucketed",
            metric,
            stats,
            state,
            padded_args,
            padded_kwargs,
            pad_count_tensor(pad, device),
            probe=probe,
            bucket=batch + pad,
        )
    mark_probed(metric)
    return out


# ---------------------------------------------------------------------------
# bootstrap replicate programs
# ---------------------------------------------------------------------------
def _make_bootstrap_entry(key: Any, pins: Tuple) -> SharedEntry:
    entry = SharedEntry(key, "bootstrap_update", pins)

    def _replicates(inst, stacked, idx, args, kwargs):
        # one replicate after another: replicate b gathers its resampled
        # batch (the rows idx[b]) and runs the template's transition on
        # slice b of the stacked states. Its new states go into one [B, ...]
        # output, so the gathered batch and the update's temporaries are
        # freed before the next replicate and a capture holds one of each.
        out: Dict[str, torch.Tensor] = {}
        with _trace.quiet_marks():
            for b in range(idx.shape[0]):
                rows = idx[b]
                sel_args, sel_kwargs = _select_rows(args, kwargs, rows)
                new = _health.traced_update(inst, {n: v[b] for n, v in stacked.items()}, sel_args, sel_kwargs)
                for n, v in new.items():
                    if b == 0:
                        out[n] = v.new_empty((idx.shape[0],) + tuple(v.shape))
                    out[n][b].copy_(v)
        return out

    entry._fns = {"exact": _replicates}
    return entry


def _select_rows(args: Tuple, kwargs: Dict[str, Any], rows: torch.Tensor) -> Tuple[Tuple, Dict[str, Any]]:
    leaves, spec = _tree.flatten((args, kwargs))
    return _tree.unflatten(spec, [x.index_select(0, rows) if isinstance(x, torch.Tensor) else x for x in leaves])


def bootstrap_transition(
    template: Any, stacked: Dict[str, torch.Tensor], idx: torch.Tensor, args: Tuple[Any, ...], kwargs: Dict[str, Any]
) -> Dict[str, torch.Tensor]:
    """Advance ``B = idx.shape[0]`` bootstrap replicates of ``template`` at
    once: ``stacked`` holds each state with a leading ``[B]`` axis, and
    replicate ``b`` updates on the batch rows ``idx[b]``. One program per
    input signature, shared by every template with the same fingerprint
    and ``B`` (a CUDA graph on the card); the template's
    ``compile_stats()`` counts its captures and cache hits. ``idx`` must
    already be on the device: a copy from the host cannot be captured."""
    key, pins = metric_fingerprint(template)
    b = int(idx.shape[0])
    entry = _get_or_create(("bootstrap_update", key, b), lambda: _make_bootstrap_entry(key, pins))
    out = entry.invoke("exact", template, instance_stats(template), stacked, idx, args, kwargs, probe=not probed(template))
    mark_probed(template)
    return out


# ---------------------------------------------------------------------------
# serving bank programs (metrics_tpu_torch.serving)
# ---------------------------------------------------------------------------
def _metric_request_body(inst: Any, state: Dict[str, Any], args: Tuple, kwargs: Dict[str, Any], pad: Any) -> Dict[str, Any]:
    return _health.traced_update(inst, state, args, kwargs, pad_count=pad)


def nest_member_states(keys: Tuple[str, ...], flat: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """A collection bank's flat ``"member::state"`` row as ``{member: {state: leaf}}``."""
    nested: Dict[str, Dict[str, Any]] = {k: {} for k in keys}
    for name, value in flat.items():
        k, state = name.split("::", 1)
        nested[k][state] = value
    return nested


def _collection_request_body(keys: Tuple[str, ...]) -> Callable:
    """The per-request transition of a collection bank: the fused update's
    member loop on one flat ``"member::state"`` row, each member with its
    own kwargs and policy (``_make_fused_entry``'s ``_update``)."""

    def body(members: List[Any], flat: Dict[str, Any], args: Tuple, kwargs: Dict[str, Any], pad: Any) -> Dict[str, Any]:
        nested = nest_member_states(keys, flat)
        new: Dict[str, Any] = {}
        for k, m in zip(keys, members):
            upd = _health.traced_update(m, nested[k], args, m._filter_kwargs(**kwargs), pad_count=pad)
            for n, v in upd.items():
                new[f"{k}::{n}"] = v
        return new

    return body


def _request_at(leaves: List[Any], spec: Any, i: int) -> Tuple[Tuple, Dict[str, Any]]:
    """Request ``i`` of a stacked wave: row ``i`` of every stacked tensor;
    the other leaves are shared by every request."""
    return _tree.unflatten(spec, [x[i] if isinstance(x, torch.Tensor) else x for x in leaves])


def _wave_program(body: Callable) -> Callable:
    """``(cell, bank, slots, args, kwargs[, pads], *, warm_up=False)``: one
    wave of requests over the resident ``bank``. Request ``i`` reads its
    row ``bank[slots[i]]`` (a copy), runs ``body`` and stores its new row
    in a ``[R, ...]`` staging buffer, which the program returns: it writes
    nothing to the bank, so a wave that raises leaves the bank as it was
    (the bank writes the rows back once the wave succeeded). Pad requests
    address the sink row past the capacity, which no tenant owns.
    ``warm_up`` (ahead of a capture) runs the first request alone and
    returns nothing: it loads the kernels and runs the Python-init probe.
    The device marks ``wave`` and ``wave_end`` open and close it; its
    requests' transitions mark nothing."""

    def wave(
        cell: Any,
        bank: Dict[str, torch.Tensor],
        slots: torch.Tensor,
        args: Tuple,
        kwargs: Dict[str, Any],
        pads: Any = None,
        *,
        warm_up: bool = False,
    ) -> Optional[Dict[str, torch.Tensor]]:
        _trace.mark("wave", slots)
        leaves, spec = _tree.flatten((args, kwargs))
        n = 1 if warm_up else int(slots.shape[0])
        staged = {name: leaf.new_empty((n,) + tuple(leaf.shape[1:])) for name, leaf in bank.items()}
        with _trace.quiet_marks():
            for i in range(n):
                row = slots[i : i + 1]
                state = {name: leaf.index_select(0, row)[0] for name, leaf in bank.items()}
                req_args, req_kwargs = _request_at(leaves, spec, i)
                new = body(cell, state, req_args, req_kwargs, None if pads is None else pads[i])
                for name, value in new.items():
                    staged[name][i].copy_(value)
                # this request's temporaries are freed before the next one's
                del state, new, req_args, req_kwargs
        _trace.mark("wave_end", slots)
        return None if warm_up else staged

    return wave


def _scan_program(body: Callable) -> Callable:
    """``(cell, bank, slot, n_steps, args, kwargs[, pads], *,
    warm_up=False)``: one tenant's epoch, ``n_steps`` stacked update batches
    folded in order into a copy of the row ``bank[slot]`` (``slot`` a
    one-element index); the program returns the new row and writes
    nothing, as a wave does. ``warm_up`` runs the first step alone and
    returns nothing."""

    def scan(
        cell: Any,
        bank: Dict[str, torch.Tensor],
        slot: torch.Tensor,
        n_steps: int,
        args: Tuple,
        kwargs: Dict[str, Any],
        pads: Any = None,
        *,
        warm_up: bool = False,
    ) -> Optional[Dict[str, torch.Tensor]]:
        leaves, spec = _tree.flatten((args, kwargs))
        state = {name: leaf.index_select(0, slot)[0] for name, leaf in bank.items()}
        with _trace.quiet_marks():
            for k in range(1 if warm_up else n_steps):
                step_args, step_kwargs = _request_at(leaves, spec, k)
                state = body(cell, state, step_args, step_kwargs, None if pads is None else pads[k])
        return None if warm_up else state

    return scan


def _make_bank_entry(cache_key: Any, kind: str, pins: Tuple, body: Callable) -> SharedEntry:
    """One bank program family. The JAX package vmaps the transition over
    the requests and donates the bank; here the bank's leaves are resident
    tensors the program reads in place (``invoke(resident=)``), it returns
    the new rows for the bank to write back, and the requests run one after another in one program (the kernel
    wrappers have no batching rule). The JAX package's ``scatter`` and
    ``dense`` variants are one program here, ``wave`` (and ``wave_pad``,
    with a per-request pad count for the pow2 correction): a loop has
    nothing to gain from running idle slots, so every wave runs its requests
    alone and an idle slot is never read or written. The bank keeps the
    JAX choice between them in its stats and its ``flush`` events only.
    A wave returns its new rows and writes nothing; no bank program holds
    a collective."""
    entry = SharedEntry(cache_key, kind, pins)
    wave = _wave_program(body)
    entry._fns = {"wave": wave, "wave_pad": wave}
    return entry


def bank_entry(template: Any, layout: Tuple = ((), 1, 0)) -> SharedEntry:
    """The shared entry of one metric's bank programs (kind
    ``bank_update``), keyed by the template's :func:`program_identity` (a
    placed member's state splits included) and the bank's ``layout`` on a
    mesh (``Resident.layout``): every bank of one metric configuration and
    layout shares it. A program key adds the variant and the wave's
    signature; on the card it adds the bank's leaf addresses too (a graph
    bakes them), so each bank captures its own graphs under the shared
    entry."""
    key, pins = program_identity(template)
    cache_key = ("bank_update", key, layout)
    return _get_or_create(cache_key, lambda: _make_bank_entry(cache_key, "bank_update", pins, _metric_request_body))


def collection_bank_entry(keys: Tuple[str, ...], members: List[Any], layout: Tuple = ((), 1, 0)) -> SharedEntry:
    """The shared entry of one collection bank's programs (kind
    ``collection_bank``), keyed as :func:`fused_entry` is: the member names
    and every member's fingerprint, and the bank's ``layout``."""
    member_keys: List[Any] = []
    pins: List[Any] = []
    for m in members:
        k, p = metric_fingerprint(m)
        member_keys.append(k)
        pins.extend(p)
    cache_key = ("collection_bank", tuple(keys), tuple(member_keys), layout)
    body = _collection_request_body(tuple(keys))

    def factory() -> SharedEntry:
        entry = _make_bank_entry(cache_key, "collection_bank", tuple(pins), body)
        entry._member_names = tuple(keys)
        return entry

    return _get_or_create(cache_key, factory)


def bank_drive_entry(template: Any, layout: Tuple = ((), 1, 0)) -> SharedEntry:
    """The shared entry of one metric's bank epochs (kind ``bank_drive``,
    variants ``scan`` and ``scan_pad``), keyed as :func:`bank_entry`."""
    key, pins = program_identity(template)
    cache_key = ("bank_drive", key, layout)

    def factory() -> SharedEntry:
        entry = SharedEntry(cache_key, "bank_drive", pins)
        scan = _scan_program(_metric_request_body)
        entry._fns = {"scan": scan, "scan_pad": scan}
        return entry

    return _get_or_create(cache_key, factory)


# ---------------------------------------------------------------------------
# fused collection programs
# ---------------------------------------------------------------------------
def _make_fused_entry(kind: str, keys: Tuple[str, ...], cache_key: Any, pins: Tuple) -> SharedEntry:
    entry = SharedEntry(cache_key, kind, pins)
    entry._member_names = keys

    def _update(members, states, args, member_kwargs, pad_count=None):
        out = {
            k: _health.traced_update(m, states[k], args, member_kwargs[k], pad_count=pad_count)
            for k, m in zip(keys, members)
        }
        _trace.mark("end", states)
        return out

    def _forward(members, states, args, member_kwargs):
        vals: Dict[str, Any] = {}
        merged: Dict[str, Any] = {}
        for k, m in zip(keys, members):
            batch_state = _health.traced_update(m, m.init_state(), args, member_kwargs[k])
            m._restore_state(batch_state)
            vals[k] = m._compute_impl()
            merged[k] = m.merge_states(states[k], batch_state)
        _trace.mark("end", states)
        return vals, merged

    def _compute(members, states):
        vals: Dict[str, Any] = {}
        for k, m in zip(keys, members):
            m._restore_state(states[k])
            vals[k] = m._compute_impl()
        return vals

    if kind == "fused_update":
        entry._fns = {"exact": _update, "bucketed": _update}
    elif kind == "fused_forward":
        entry._fns = {"exact": _forward}
    else:
        entry._fns = {"exact": _compute}
    return entry


def fused_entry(kind: str, keys: Tuple[str, ...], members: List[Any]) -> SharedEntry:
    """The shared entry of a collection's fused program, keyed by the member
    names and every member's fingerprint: clones of one collection, and
    collections with the same members, share it."""
    member_keys: List[Any] = []
    pins: List[Any] = []
    for m in members:
        k, p = metric_fingerprint(m)
        member_keys.append(k)
        pins.extend(p)
    cache_key = (kind, tuple(keys), tuple(member_keys))
    return _get_or_create(cache_key, lambda: _make_fused_entry(kind, tuple(keys), cache_key, tuple(pins)))


# ---------------------------------------------------------------------------
# encoder programs (metrics_tpu_torch.encoders)
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _encoder_capture_flags() -> Any:
    """cuDNN as a capture needs it: ``benchmark`` off (its trial runs would
    be captured) and TF32 off (the kernels chosen at capture are replayed)."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=False, deterministic=cudnn.deterministic, allow_tf32=False):
        yield


def _make_encoder_entry(cache_key: Any, pins: Tuple, consumer: Optional[Callable]) -> SharedEntry:
    """One encoder program family (entry kind ``encode``); the cell is a
    :class:`~metrics_tpu_torch.encoders.ShardedEncoder`. Variants:

    * ``encode``: ``(params, *inputs) -> features``, the forward;
    * ``encode_acc`` (only with a ``consumer``): ``(params, carry, valid,
      *inputs) -> carry``, the forward and ``consumer(carry, features,
      valid)`` in one program (the features this process's rows at full
      width, before the ``out_spec`` block). ``valid`` is a float row mask (pad and
      screened rows are 0), so ragged pow2-bucketed chunks share the
      program of their bucket.

    Both bodies run under :func:`_encoder_capture_flags`, so the warm-up and
    the capture see the same cuDNN settings.
    """
    entry = SharedEntry(cache_key, "encode", pins)

    def _encode(enc, params, *inputs):
        with _encoder_capture_flags():
            return enc._traced_apply(params, inputs)

    def _encode_acc(enc, params, carry, valid, *inputs):
        with _encoder_capture_flags():
            return consumer(carry, enc._traced_features(params, inputs), valid)

    entry._fns = {"encode": _encode}
    if consumer is not None:
        entry._fns["encode_acc"] = _encode_acc
    return entry


def encoder_entry(encoder: Any, consumer: Optional[Callable] = None) -> SharedEntry:
    """Shared entry for one encoder program family, keyed as in the JAX
    engine: the encoder's program identity (apply callable, parameter
    signature, canonical ``param_specs``/``in_specs``/``out_spec``, mesh)
    and, for the fused streaming step, the consumer's identity.
    Parameter values are runtime data, so cloned or rebuilt encoders of one
    identity share one program per input signature."""
    key, pins = encoder._program_key()
    cache_key = ("encode", key, None if consumer is None else id(consumer))
    all_pins = tuple(pins) + ((consumer,) if consumer is not None else ())
    return _get_or_create(cache_key, lambda: _make_encoder_entry(cache_key, all_pins, consumer))


# ---------------------------------------------------------------------------
# introspection
# ---------------------------------------------------------------------------
def clear_cache() -> None:
    """Drop every shared entry with its graphs (and their warmed marks).
    Instances keep their own ``compile_stats()`` counters. The graphs'
    memory pool goes with them: once its last graph is freed the allocator
    releases the pool, and a capture into the released pool's handle fails
    an allocator assertion, so later captures take a fresh pool."""
    with _LOCK:
        _CACHE.clear()
        _POOLS.clear()


def cache_summary() -> Dict[str, Any]:
    """Process-wide telemetry over every shared entry, with the persistent
    kernel cache's counters (``persistent_cache``)."""
    from metrics_tpu_torch.engine import persist as _persist

    with _LOCK:
        entries = list(_CACHE.values())
    keys = (
        "calls", "compiles", "cache_hits", "retraces", "bucketed_calls", "graphs", "failed_captures", "static_bytes",
        "warmed_programs",
    )
    totals = dict.fromkeys(keys, 0)
    by_kind: Dict[str, Dict[str, int]] = {}
    for e in entries:
        s = e.summary()
        kind = by_kind.setdefault(s["kind"], {"entries": 0, **dict.fromkeys(keys, 0)})
        kind["entries"] += 1
        for k in keys:
            kind[k] += s[k]
            totals[k] += s[k]
    return {"entries": len(entries), **totals, "by_kind": by_kind, "persistent_cache": _persist.persistent_cache_stats()}

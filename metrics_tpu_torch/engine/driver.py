"""Device-resident evaluation driver and the async results plane
(counterpart of ``metrics_tpu/engine/driver.py``).

* **K steps per program.** :func:`drive` runs an evaluation epoch through one
  program family of the engine cache (entry kind ``driver``): a CUDA graph of
  ``K = steps_per_chunk`` consecutive fused update steps, replayed once per
  chunk, where the JAX engine runs ``lax.scan`` over the whole epoch. Each
  step is the same health-screened transition every per-step program runs
  (``resilience/health.traced_update``), so the states equal the per-step
  loop's, integer counts bit for bit.
* **Ragged tails.** A short final batch is zero-padded to the chunk's batch
  and its pad rows subtracted by the bucketing correction (the ``scan_pad``
  variants), for row-additive members; a short final chunk is padded with
  whole zero steps when a full chunk of its shape ran before.
* **Host iterables stream.** CPU batches are stacked into ``[K, batch]``
  chunks in pinned host memory, two buffers deep, and copied to the card on
  a side stream while the previous chunk's graph replays.
* **compute_in_trace** folds the members' computes into the last chunk's
  program (the ``*_cmp`` variants); a member whose compute cannot run as a
  program is computed on the host afterwards.
* **Async results.** :func:`async_compute` (``Metric.compute_async`` and
  ``MetricCollection.compute_async``) packs every result tensor into one
  device buffer and starts ONE device-to-host copy into pinned memory behind
  a CUDA event; :meth:`AsyncResult.result` waits for that event only.

While tracing or the event bus is on, :func:`drive` runs in one ``drive``
span, and a resolved :class:`AsyncResult` emits one ``fetch`` event.

Members a chunk cannot carry keep their per-step contracts inside the same
:func:`drive` call: list states, eager fallbacks, ``on_bad_input="raise"``
(its per-update host check is the point) and the eager health policies.

**Mesh modes** (a ``torch.distributed.device_mesh.DeviceMesh``, one process
per device; every process passes the same whole stacked epoch):

* ``axis_name=`` (with ``mesh=``, optionally ``hierarchical_sync=True``):
  the steps are split into contiguous blocks over the named axes; each
  process runs its block from the defaults, the states are synced over the
  axes (``comm.sync_state_trees``) and the prior states merged after the
  sync, so an accumulated state is never multiplied by the world.
* ``in_specs=`` (with ``mesh=``): the batch axis of each input is split by
  its spec (``sharding/reduce.py``); registered-sharded states are placed
  and carried as local shards (the class-windowed kernels count a
  process's rows only), each process runs the epoch on its batch slice
  from the defaults, the partial states are summed over the input axes,
  and the prior merged.

Both sync in the last chunk's program where the backend's collectives can
be captured (NCCL); on gloo the sync runs right after the last replay.
``compile_stats()["mesh_sync"]`` says which (``"in_program"`` or
``"after_program"``). After an ``axis_name`` drive, or an ``in_specs``
drive over a mesh of more than one process, the states are the global
ones: the host sync is disarmed and host updates raise until ``reset()``.

:func:`drive_bank` folds one tenant's epoch into its serving-bank row.

**Drive snapshots** (``snapshot_store=``, ``snapshot_every=``,
``resume_from=``): a local epoch seals its members' states at chunk
boundaries into a :class:`~metrics_tpu_torch.serving.SpillStore`, in the
JAX package's bytes (:class:`DriveSnapshot`, schema family ``snapshot``):
the boundary's states start their copy to the host (:class:`AsyncResult`)
and are sealed and written one boundary later, so the card never waits on
the store. A stacked epoch with ``snapshot_every`` below the chunk length
runs in chunks of ``snapshot_every`` steps. A killed epoch re-enters with
``resume_from=`` through the same chunk programs; the chunks run their
steps in order, so every chunking gives the same states bit for bit.
"""
import json
import struct
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from metrics_tpu_torch.engine import _tree
from metrics_tpu_torch.engine import bucketing as _bucketing
from metrics_tpu_torch.engine import cache as _cache
from metrics_tpu_torch.obs import bus as _bus
from metrics_tpu_torch.obs import trace as _trace
from metrics_tpu_torch.parallel import comm as _comm
from metrics_tpu_torch.resilience import health as _health
from metrics_tpu_torch.sharding import reduce as _shard_reduce
from metrics_tpu_torch.sharding import spec as _shard_spec
from metrics_tpu_torch.utils.data import _squeeze_if_scalar
from metrics_tpu_torch.utils.exceptions import MetricsUserError

__all__ = [
    "AsyncResult",
    "DriveResult",
    "DriveSnapshot",
    "async_compute",
    "drive",
    "drive_bank",
    "fetch_stats",
    "load_drive_snapshot",
    "reset_fetch_stats",
]


# ---------------------------------------------------------------------------
# async coalesced results
# ---------------------------------------------------------------------------
_UNSET = object()
_FETCH_LOCK = threading.Lock()
_FETCH_STATS = {"async_fetches": 0, "coalesced_leaves": 0}
_ALIGN = 16


def fetch_stats() -> Dict[str, int]:
    """``async_fetches``: resolved :class:`AsyncResult` handles, one
    device-to-host copy each; ``coalesced_leaves``: the tensors they carried."""
    with _FETCH_LOCK:
        return dict(_FETCH_STATS)


def reset_fetch_stats() -> None:
    with _FETCH_LOCK:
        _FETCH_STATS["async_fetches"] = 0
        _FETCH_STATS["coalesced_leaves"] = 0


class AsyncResult:
    """A handle on a results tree whose copy to the host has started.

    On the card the constructor packs every result tensor into one device
    buffer (each at a 16-byte offset), starts one non-blocking copy into
    pinned host memory and records an event. :meth:`result` waits for that
    event, unpacks CPU tensors bitwise equal to the device values and caches
    them: resolving twice costs one copy. CPU results need no copy.
    """

    __slots__ = ("_tree", "_host", "_source", "_n_leaves", "_lock", "_event", "_pinned", "_layout")

    def __init__(self, tree: Any, source: str = "") -> None:
        self._host: Any = _UNSET
        self._source = source
        self._lock = threading.Lock()
        self._event = self._pinned = None
        leaves, spec = _tree.flatten(tree)
        self._n_leaves = len(leaves)
        self._tree = (leaves, spec)
        cuda = [x for x in leaves if isinstance(x, torch.Tensor) and x.is_cuda]
        if not cuda:
            self._layout = None
            return
        device = cuda[0].device
        layout, offset = [], 0
        for x in leaves:
            if isinstance(x, torch.Tensor) and x.is_cuda:
                n = x.numel() * x.element_size()
                layout.append((offset, n, x.dtype, tuple(x.shape)))
                offset += -(-n // _ALIGN) * _ALIGN
            else:
                layout.append(None)
        packed = torch.empty(max(offset, 1), dtype=torch.uint8, device=device)
        for x, slot in zip(leaves, layout):
            if slot is not None and slot[1]:
                packed[slot[0]:slot[0] + slot[1]].copy_(x.detach().contiguous().reshape(-1).view(torch.uint8))
        self._pinned = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
        self._pinned.copy_(packed, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record()
        self._layout = layout

    def ready(self) -> bool:
        """True when resolving would not wait for the device."""
        return self._host is not _UNSET or self._event is None or self._event.query()

    def result(self) -> Any:
        """The results tree on the host (CPU tensors)."""
        if self._host is _UNSET:
            fetched = False
            with self._lock:
                if self._host is _UNSET:
                    leaves, spec = self._tree
                    if self._layout is not None:
                        self._event.synchronize()
                        leaves = [
                            x if slot is None else self._unpack(slot) for x, slot in zip(leaves, self._layout)
                        ]
                    self._host = _tree.unflatten(spec, leaves)
                    self._tree = None  # do not pin the device results
                    fetched = True
            if fetched:
                with _FETCH_LOCK:
                    _FETCH_STATS["async_fetches"] += 1
                    _FETCH_STATS["coalesced_leaves"] += self._n_leaves
                # no lock held here: a subscriber may call fetch_stats()
                if _bus.enabled():
                    _bus.emit("fetch", source=self._source, leaves=self._n_leaves, coalesced=True)
        return self._host

    def _unpack(self, slot: Tuple) -> torch.Tensor:
        offset, n, dtype, shape = slot
        return self._pinned[offset:offset + n].view(dtype).reshape(shape).clone()

    def __repr__(self) -> str:
        state = "resolved" if self._host is not _UNSET else ("ready" if self.ready() else "pending")
        return f"AsyncResult(source={self._source!r}, leaves={self._n_leaves}, {state})"


def async_compute(obj: Any) -> AsyncResult:
    """``obj.compute()`` as an :class:`AsyncResult`: the compute dispatches
    as usual (fused for a collection); only the copy is deferred."""
    return AsyncResult(obj.compute(), source=type(obj).__name__)


# ---------------------------------------------------------------------------
# drive
# ---------------------------------------------------------------------------
class DriveResult:
    """What one :func:`drive` did: ``steps`` consumed, ``chunks`` (program
    replays or runs), the member keys driven in chunks (``fused_keys``) and
    per step (``eager_keys``), with ``compute_in_trace`` the ``values``, and
    the drive snapshots it wrote (``snapshots``)."""

    __slots__ = ("steps", "chunks", "fused_keys", "eager_keys", "values", "snapshots")

    def __init__(
        self,
        steps: int,
        chunks: int,
        fused_keys: Tuple[str, ...],
        eager_keys: Tuple[str, ...],
        values: Any,
        snapshots: int = 0,
    ) -> None:
        self.steps = steps
        self.chunks = chunks
        self.fused_keys = fused_keys
        self.eager_keys = eager_keys
        self.values = values
        self.snapshots = snapshots

    def __repr__(self) -> str:
        return f"DriveResult(steps={self.steps}, chunks={self.chunks}, fused_keys={self.fused_keys}, eager_keys={self.eager_keys})"


# ---------------------------------------------------------------------------
# drive snapshots: sealed mid-epoch states and resume
# ---------------------------------------------------------------------------
_SNAPSHOT_VERSION = 1
_SNAP_SEP = "\x00"  # member key / state name separator of the flat payload


class DriveSnapshot:
    """One sealed mid-epoch state: ``step`` steps done, the fused members'
    states at that boundary (``{member_key: {state: CPU tensor}}``), whether
    it is the epoch's ``final`` one, and the attributes the members learned
    in their first update (``dynamics``: ``Accuracy.mode``, the set a
    checkpoint carries). Written by ``drive(snapshot_store=)``, read by
    ``drive(resume_from=)`` and :func:`load_drive_snapshot`."""

    __slots__ = ("step", "states", "final", "dynamics")

    def __init__(
        self,
        step: int,
        states: Dict[str, Dict[str, Any]],
        final: bool = False,
        dynamics: Optional[Dict[str, Dict[str, Any]]] = None,
    ) -> None:
        self.step = int(step)
        self.states = states
        self.final = bool(final)
        self.dynamics = dynamics or {}

    def __repr__(self) -> str:
        return f"DriveSnapshot(step={self.step}, members={sorted(self.states)}, final={self.final})"


def _snapshot_store_key(snapshot_key: str) -> str:
    return f"drive/{snapshot_key}"


def _seal_snapshot(
    states: Dict[str, Dict[str, Any]],
    step: int,
    final: bool,
    dynamics: Optional[Dict[str, Dict[str, Any]]] = None,
) -> bytes:
    """The JAX package's snapshot bytes: an envelope around a JSON meta
    (version, step, member keys, learned attributes) and the flat states as
    one exact tenant payload (``serving/store.encode_tenant_payload``, every
    leaf attested by its digest)."""
    from metrics_tpu_torch.metric import _encode_dynamic
    from metrics_tpu_torch.parallel import groups as _groups
    from metrics_tpu_torch.serving import store as _payload

    flat: Dict[str, Any] = {}
    for member_key, state in states.items():
        for name, value in state.items():
            flat[f"{member_key}{_SNAP_SEP}{name}"] = value
    inner = _payload.encode_tenant_payload(flat, precisions=None)
    dyn = {k: {a: _encode_dynamic(v) for a, v in attrs.items()} for k, attrs in (dynamics or {}).items() if attrs}
    meta = json.dumps(
        {"v": _SNAPSHOT_VERSION, "step": int(step), "final": bool(final), "keys": sorted(states), "dyn": dyn}
    ).encode("utf-8")
    return _groups.pack_envelope(struct.pack(">I", len(meta)) + meta + inner)


def _unseal_snapshot(payload: bytes, context: str = "") -> DriveSnapshot:
    """Decode a drive snapshot through the durable-schema registry: one
    sealed by a newer build raises ``SchemaVersionError``."""
    from metrics_tpu_torch.resilience import schema as _schema

    return _schema.decode_any("snapshot", payload, context=context)


def _snapshot_meta(payload: bytes, context: str) -> Tuple[Dict[str, Any], bytes]:
    from metrics_tpu_torch.parallel import groups as _groups
    from metrics_tpu_torch.utils.exceptions import SyncIntegrityError

    _version, body = _groups.unpack_envelope(payload, context)
    if len(body) < 4:
        raise SyncIntegrityError(f"Truncated drive snapshot{context}.")
    (meta_len,) = struct.unpack(">I", body[:4])
    try:
        meta = json.loads(body[4 : 4 + meta_len].decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as err:
        raise SyncIntegrityError(f"Unparseable drive-snapshot meta{context}: {err}") from err
    if not isinstance(meta, dict):
        raise SyncIntegrityError(f"Drive-snapshot meta is not an object{context}.")
    return meta, body[4 + meta_len :]


def _snapshot_version_of(payload: bytes) -> Any:
    return _snapshot_meta(payload, "")[0].get("v")


def _decode_snapshot_v1(payload: bytes, context: str) -> DriveSnapshot:
    from metrics_tpu_torch.metric import _decode_dynamic
    from metrics_tpu_torch.serving import store as _payload

    meta, inner = _snapshot_meta(payload, context)
    flat = _payload.decode_tenant_payload(inner, context)
    states: Dict[str, Dict[str, Any]] = {}
    for flat_key, value in flat.items():
        member_key, _, name = flat_key.partition(_SNAP_SEP)
        states.setdefault(member_key, {})[name] = value
    dynamics = {k: {a: _decode_dynamic(v) for a, v in attrs.items()} for k, attrs in meta.get("dyn", {}).items()}
    return DriveSnapshot(int(meta["step"]), states, final=bool(meta.get("final", False)), dynamics=dynamics)


def _register_snapshot_schemas() -> None:
    from metrics_tpu_torch.resilience import schema as _schema

    _schema.register_schema("snapshot", _SNAPSHOT_VERSION, _decode_snapshot_v1, prober=_snapshot_version_of)


_register_snapshot_schemas()


def load_drive_snapshot(store: Any, snapshot_key: str = "drive") -> DriveSnapshot:
    """The snapshot ``drive(snapshot_store=store, snapshot_key=...)`` sealed
    last: what ``drive(resume_from=)`` re-enters from."""
    from metrics_tpu_torch.serving import store as _spill

    try:
        payload = store.get(_snapshot_store_key(snapshot_key))
    except KeyError:
        raise KeyError(
            f"no drive snapshot under key {snapshot_key!r} in {type(store).__name__};"
            " was drive(snapshot_store=, snapshot_key=) ever run against this store?"
        ) from None
    _spill.bump("blob_reads")
    return _unseal_snapshot(payload, context=f" (drive snapshot {snapshot_key!r})")


class _SnapshotCtx:
    """The deferred snapshot writer: a boundary's states start their copy to
    the host at once (an :class:`AsyncResult`; a chunk's states are tensors
    of their own, never a graph's, so later chunks leave them as they are)
    and are sealed and written into the store one boundary later, so the
    store's I/O overlaps the next chunk on the card."""

    def __init__(self, store: Any, every: Optional[int], key: str, source: str) -> None:
        self.store = store
        self.every = every
        self.key = key
        self.source = source
        self.base_step = 0  # steps done before this call (a resume)
        self.written = 0
        self.last_snap_step = 0
        self._pending: Optional[Tuple[AsyncResult, int, bool, Dict[str, Dict[str, Any]]]] = None

    def due(self, steps_done: int) -> bool:
        return self.every is not None and steps_done - self.last_snap_step >= self.every

    def stage(self, fused: List[Tuple[str, Any]], states: Dict[str, Dict[str, Any]], steps_done: int, final: bool) -> None:
        """Queue the states after ``steps_done`` steps of this call; write the
        boundary queued before."""
        dynamics = {k: {a: getattr(m, a) for a in m._dynamic_state_attrs} for k, m in fused}
        handle = AsyncResult(states, source=f"{self.source}:snapshot")
        prev, self._pending = self._pending, (handle, self.base_step + steps_done, final, dynamics)
        self.last_snap_step = steps_done
        if prev is not None:
            self._write(prev)
        if final:
            self.flush()

    def flush(self) -> None:
        pending, self._pending = self._pending, None
        if pending is not None:
            self._write(pending)

    def _write(self, staged: Tuple[AsyncResult, int, bool, Dict[str, Dict[str, Any]]]) -> None:
        from metrics_tpu_torch.serving import store as _spill

        handle, step, final, dynamics = staged
        payload = _seal_snapshot(handle.result(), step, final, dynamics=dynamics)
        self.store.put(_snapshot_store_key(self.key), payload)
        self.written += 1
        _spill.bump("snapshots")
        _spill.bump("snapshot_bytes", len(payload))
        if _bus.enabled():
            _bus.emit("snapshot", source=self.source, key=self.key, step=step, bytes=len(payload), final=final)


def _resolve_resume(resume_from: Any, snapshot_key: str) -> Optional[DriveSnapshot]:
    if resume_from is None:
        return None
    if isinstance(resume_from, DriveSnapshot):
        return resume_from
    return load_drive_snapshot(resume_from, snapshot_key)


def _bind_resume(fused: List[Tuple[str, Any]], resume: DriveSnapshot, source: str) -> None:
    """Bind a snapshot as the epoch's starting states: each member's states
    checked against its registered defaults (names, shapes, the kind of
    dtype) and restored as sealed on the member's device, its learned
    attributes set, its update count and screening counter advanced by the
    snapshot's steps."""
    from metrics_tpu_torch.serving import store as _spill
    from metrics_tpu_torch.utils.checkpoint import dtype_kind

    keys = tuple(k for k, _ in fused)
    if set(keys) != set(resume.states):
        raise MetricsUserError(
            f"drive(resume_from=): the snapshot covers members {sorted(resume.states)} but this drive fuses"
            f" {sorted(keys)} — resume needs the same metric/collection composition the snapshot was taken from."
        )
    for k, m in fused:
        cls = type(m).__name__
        state = resume.states[k]
        if set(state) != set(m._defaults):
            raise MetricsUserError(
                f"drive(resume_from=): member {k!r} ({cls}) registers states {sorted(m._defaults)} but the snapshot"
                f" holds {sorted(state)} — different class or config?"
            )
        restored: Dict[str, Any] = {}
        for name, value in state.items():
            default = m._defaults[name]
            tensor = torch.as_tensor(value)
            if tuple(tensor.shape) != tuple(default.shape):
                raise MetricsUserError(
                    f"drive(resume_from=): state {name!r} of {cls} has registered shape {tuple(default.shape)} but the"
                    f" snapshot holds {tuple(tensor.shape)} — different config (e.g. another num_classes)?"
                )
            if dtype_kind(tensor.dtype) != dtype_kind(default.dtype):
                raise MetricsUserError(
                    f"drive(resume_from=): state {name!r} of {cls} is registered as {dtype_kind(default.dtype)} but"
                    f" the snapshot holds {dtype_kind(tensor.dtype)}."
                )
            restored[name] = tensor.to(default.device)
        m._restore_state(restored)
        # keyed before it learns the snapshot's attributes, as the
        # interrupted run's instance was: the same programs serve the rest
        _cache.metric_fingerprint(m)
        for attr, value in resume.dynamics.get(k, {}).items():
            setattr(m, attr, value)
        m._update_count += resume.step
        m._computed = None
        if _health.health_enabled(m):
            m._health_stats["batches_screened"] += resume.step
    _spill.bump("resumes")
    if _bus.enabled():
        _bus.emit("recover", source=source, scope="drive", step=resume.step, final=resume.final)


def _raise_not_snapshotable(eager_keys: Tuple[str, ...]) -> None:
    raise MetricsUserError(
        "drive snapshots/resume (snapshot_store=/resume_from=) need every member scan-drivable: the snapshot IS"
        " the chunks' states, and an eager-fallback/list-state/'raise'-policy member's state never rides them;"
        f" offending members: {sorted(set(eager_keys))}. Drive them in a separate plain drive(), or checkpoint them"
        " with utils.checkpoint."
    )


def _members_of(obj: Any) -> Tuple[Tuple[str, ...], List[Any]]:
    """``(keys, members)``; a metric is a one-member collection keyed ``"_"``."""
    from metrics_tpu_torch.collections import MetricCollection

    if isinstance(obj, MetricCollection):
        items = obj.items(keep_base=True)
        return tuple(k for k, _ in items), [m for _, m in items]
    return ("_",), [obj]


def _scan_drivable(m: Any) -> bool:
    """Can the member ride the chunk programs without losing a contract?"""
    if not (m._enable_jit and not m._jit_failed and not m.dist_sync_on_step and not m._has_list_state()):
        return False
    if m._is_synced:
        return False
    if _health.health_enabled(m) and (_health.forces_eager(m) or m.on_bad_input == "raise"):
        return False
    return True


def _steps_iter(batches: Iterable[Any]):
    for item in batches:
        yield tuple(item) if isinstance(item, (tuple, list)) else (item,)


def _stacked_steps(batches: Any) -> Optional[Tuple[Tuple[torch.Tensor, ...], int]]:
    """``(args, n_steps)`` when ``batches`` is a tuple of tensors sharing a
    leading steps axis, else None (an iterable of steps)."""
    if isinstance(batches, torch.Tensor):
        batches = (batches,)
    if not isinstance(batches, tuple) or not batches:
        return None
    if not all(isinstance(x, torch.Tensor) and x.ndim >= 1 for x in batches):
        return None
    n = int(batches[0].shape[0])
    if any(int(x.shape[0]) != n for x in batches):
        return None
    return batches, n


def _make_driver_entry(
    cache_key: Any, keys: Tuple[str, ...], compute_keys: Tuple[str, ...], pins: Tuple, sync: Optional[Any] = None
) -> _cache.SharedEntry:
    entry = _cache.SharedEntry(cache_key, "driver", pins)
    entry._member_names = keys
    entry._compute_keys = compute_keys

    def _chunk(members, states, leaves, pads, treedef, compute):
        steps = int(leaves[0].shape[0])
        for k in range(steps):
            args, kwargs = _tree.unflatten(treedef, [x[k] for x in leaves])
            pad = None if pads is None else pads[k]
            states = {
                key: _health.traced_update(m, states[key], args, m._filter_kwargs(**kwargs), pad_count=pad)
                for key, m in zip(keys, members)
            }
        if not compute:
            return states
        vals: Dict[str, Any] = {}
        for key, m in zip(keys, members):
            if key in compute_keys:
                m._restore_state(states[key])
                vals[key] = m._compute_impl()
        return states, vals

    def _mesh_chunk(members, states, leaves, pads, treedef, extra):
        # a mesh drive's chunk: the whole-batch quarantine verdicts and this
        # process's share of the quarantine count ride along (sharding/reduce.py)
        bad, share = extra["bad"], extra["share"]
        for k in range(int(leaves[0].shape[0])):
            args, kwargs = _tree.unflatten(treedef, [x[k] for x in leaves])
            pad = None if pads is None else pads[k]
            states = {
                key: _health.traced_update(
                    m,
                    states[key],
                    args,
                    m._filter_kwargs(**kwargs),
                    pad_count=pad,
                    global_bad=None if bad.get(key) is None else bad[key][k],
                    quarantine_share=share,
                )
                for key, m in zip(keys, members)
            }
        return states

    def _mesh_chunk_sync(members, states, leaves, pads, treedef, extra):
        return sync(members, _mesh_chunk(members, states, leaves, pads, treedef, extra), extra["prior"])

    entry._fns = {
        "scan": lambda members, states, leaves, treedef: _chunk(members, states, leaves, None, treedef, False),
        "scan_pad": lambda members, states, leaves, pads, treedef: _chunk(members, states, leaves, pads, treedef, False),
        "scan_cmp": lambda members, states, leaves, treedef: _chunk(members, states, leaves, None, treedef, True),
        "scan_pad_cmp": lambda members, states, leaves, pads, treedef: _chunk(members, states, leaves, pads, treedef, True),
    }
    if sync is not None:
        entry._fns["mesh_scan"] = _mesh_chunk
        entry._fns["mesh_scan_sync"] = _mesh_chunk_sync
    return entry


def _driver_entry(
    keys: Tuple[str, ...], members: List[Any], compute_keys: Tuple[str, ...], mesh_sync: Optional[Tuple] = None
) -> _cache.SharedEntry:
    """The chunk programs' shared entry. ``mesh_sync`` is ``(mesh, axes,
    hierarchical)`` for a mesh drive: its sync is part of the last chunk's
    program, so the mesh (by identity) and the axes key the entry."""
    member_keys, pins = [], []
    for m in members:
        k, p = _cache.metric_fingerprint(m)
        member_keys.append(k)
        pins.extend(p)
    sync_key = None
    sync = None
    if mesh_sync is not None:
        mesh, axes, hierarchical = mesh_sync
        pins.append(mesh)
        sync_key = (id(mesh), axes, hierarchical)
        sync = _mesh_finish(keys, mesh, axes, hierarchical)
    cache_key = ("driver", keys, tuple(member_keys), compute_keys, sync_key)
    return _cache._get_or_create(
        cache_key, lambda: _make_driver_entry(cache_key, keys, compute_keys, tuple(pins), sync=sync)
    )


def _mesh_finish(keys: Tuple[str, ...], mesh: Any, axes: Tuple[str, ...], hierarchical: bool) -> Any:
    """``(members, delta, prior) -> states``: the partial states synced over
    ``axes`` (``comm.live_axes``: an axis of one gloo process needs no
    collective), then merged into the prior ones."""
    live = _comm.live_axes(mesh, axes)

    def finish(members, delta, prior):
        if live:
            delta = _comm.sync_state_trees(
                delta,
                {k: m._reductions for k, m in zip(keys, members)},
                live,
                placeholders={k: m._list_placeholders for k, m in zip(keys, members)},
                hierarchical=hierarchical and len(live) >= 2,
                mesh=mesh,
            )
        return {k: m.merge_states(prior[k], delta[k]) for k, m in zip(keys, members)}

    return finish


class _Staging:
    """Pinned host buffers and device buffers for ``[K, ...]`` chunks of CPU
    steps, two deep: the host fills one while the other's copy to the card
    and the replay that reads it run. Copies go on a side stream."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        self.slots: List[Dict[str, Any]] = [{}, {}]
        self.turn = 0

    def stage(self, steps: List[List[Any]]) -> Tuple[List[torch.Tensor], Any]:
        slot = self.slots[self.turn]
        self.turn ^= 1
        cols = list(zip(*steps))
        sig = tuple((len(col), tuple(col[0].shape), col[0].dtype) for col in cols)
        if slot.get("sig") != sig:
            slot.clear()
            slot["sig"] = sig
            slot["host"] = [torch.empty((len(c), *c[0].shape), dtype=c[0].dtype, pin_memory=True) for c in cols]
            slot["dev"] = [torch.empty(h.shape, dtype=h.dtype, device=self.device) for h in slot["host"]]
        if slot.get("copied") is not None:
            slot["copied"].synchronize()  # the last copy out of these pinned buffers is done
        for host, col in zip(slot["host"], cols):
            for k, x in enumerate(col):
                host[k].copy_(x)
        with torch.cuda.stream(self.stream):
            if slot.get("consumed") is not None:
                self.stream.wait_event(slot["consumed"])  # the replay read the device buffers
            for dev, host in zip(slot["dev"], slot["host"]):
                dev.copy_(host, non_blocking=True)
            slot["copied"] = torch.cuda.Event()
            slot["copied"].record(self.stream)
        return slot["dev"], slot

    @staticmethod
    def consumed(slot: Dict[str, Any]) -> None:
        slot["consumed"] = torch.cuda.Event()
        slot["consumed"].record()


def _as_step_tensor(x: Any) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _ragged_pad(
    leaves: List[Any], chunk_leaves0: List[Any], treedef: Any, chunk_treedef: Any, batched: Tuple[int, ...]
) -> Optional[Tuple[List[Any], int]]:
    """A short final batch zero-padded to the chunk's batch: ``(leaves,
    pad)``, or None when the step is not the chunk's shape plus pad rows."""
    if treedef != chunk_treedef or len(leaves) != len(chunk_leaves0) or not batched:
        return None
    batch = int(chunk_leaves0[batched[0]].shape[0])
    pad = None
    for i, (leaf, ref) in enumerate(zip(leaves, chunk_leaves0)):
        if not isinstance(leaf, torch.Tensor) or not isinstance(ref, torch.Tensor):
            if type(leaf) is not type(ref):  # python scalars stack like 0-d tensors
                return None
            continue
        if leaf.dtype != ref.dtype:
            return None
        if i in batched:
            if tuple(leaf.shape[1:]) != tuple(ref.shape[1:]) or leaf.shape[0] >= batch:
                return None
            step_pad = batch - int(leaf.shape[0])
            if pad is not None and step_pad != pad:
                return None
            pad = step_pad
        elif tuple(leaf.shape) != tuple(ref.shape):
            return None
    if pad is None:
        return None
    return _bucketing.pad_leaves(leaves, batched, pad), pad


def _step_sig(leaves: List[Any], treedef: Any) -> Tuple:
    # a python scalar is staged as a 0-d tensor: its type, not its value, keys the chunk
    return (treedef, tuple((tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor) else ("py", type(x)) for x in leaves))


def drive(
    obj: Any,
    batches: Any,
    *,
    compute_in_trace: bool = False,
    axis_name: Optional[Any] = None,
    mesh: Optional[Any] = None,
    in_specs: Optional[Any] = None,
    steps_per_chunk: int = 16,
    hierarchical_sync: bool = False,
    snapshot_store: Optional[Any] = None,
    snapshot_every: Optional[int] = None,
    snapshot_key: str = "drive",
    resume_from: Optional[Any] = None,
) -> DriveResult:
    """Run one evaluation epoch through the engine's chunk programs.

    Args:
        obj: a ``Metric`` or ``MetricCollection``; its states accumulate as
            if every batch had gone through ``update()``.
        batches: a **stacked** tuple of tensors sharing a leading steps axis
            (``(preds[N, B, ...], target[N, B])``), or a **host iterable** of
            per-step argument tuples (CPU batches are staged through pinned
            memory, two chunks deep).
        compute_in_trace: fold the members' computes into the last chunk's
            program; the values come back in ``DriveResult.values``.
        steps_per_chunk: ``K``, the steps one program replay takes.
        mesh: a ``DeviceMesh`` with named dims for the mesh modes (see the
            module docstring); every process of it calls ``drive`` with the
            same stacked epoch.
        axis_name: the mesh axis (or axes, outer first) the steps are split
            over; needs ``mesh``.
        hierarchical_sync: stage the sync inner axis first; needs a tuple
            ``axis_name`` of two or more axes.
        in_specs: one ``PartitionSpec`` per stacked argument (or one for
            all), naming the axes the batch axis is split over
            (``PartitionSpec(None, "dp")``); needs ``mesh``, excludes
            ``axis_name``.
        snapshot_store: a :class:`~metrics_tpu_torch.serving.SpillStore` the
            epoch seals its states into at chunk boundaries (at most every
            ``snapshot_every`` steps), and at its end. Local epochs only
            (no ``mesh``), every member driven in chunks.
        snapshot_every: the snapshot cadence in steps (boundaries fall on
            chunks; a stacked epoch runs in chunks of at most this many
            steps). ``None``: only the final snapshot.
        snapshot_key: the store key the snapshots go under (each overwrites
            the last).
        resume_from: a store (its snapshot under ``snapshot_key``) or a
            :class:`DriveSnapshot`: the members take its states, learned
            attributes and counts, the first ``step`` steps of ``batches``
            are skipped and the rest runs through the same chunk programs,
            ending bit for bit where the uninterrupted epoch ends. Resuming
            a final snapshot binds it and runs nothing.
    """
    gspmd = in_specs is not None
    if gspmd:
        if mesh is None:
            raise ValueError(
                "drive(in_specs=...) is the sharded-state mode and"
                " needs the mesh the specs name axes of: pass mesh= too."
            )
        if axis_name is not None or hierarchical_sync:
            raise ValueError(
                "drive(in_specs=...) and drive(axis_name=...) are different"
                " mesh modes: in_specs splits the batch axis and lays the states"
                " out as registered, axis_name splits the steps axis with an"
                " explicit sync. Pass one or the other."
            )
    elif (axis_name is None) != (mesh is None):
        raise ValueError(
            "drive(axis_name=..., mesh=...) split the epoch's steps over a mesh"
            " axis and must be passed together (for a sharded-STATE epoch over"
            " a 2D mesh pass drive(mesh=, in_specs=); to sync your own loop, run"
            " the pure update_state/sync_state API inside comm.axis_env(mesh))."
        )
    if steps_per_chunk < 1:
        raise ValueError(f"steps_per_chunk must be >= 1, got {steps_per_chunk}")
    if hierarchical_sync and (axis_name is None or isinstance(axis_name, str) or len(tuple(axis_name)) < 2):
        raise ValueError(
            "drive(hierarchical_sync=True) stages the sync over a"
            " MULTI-axis mesh: pass axis_name as a tuple of >= 2 mesh axes"
            f" ordered outer->inner (e.g. ('host', 'local')), got {axis_name!r}."
        )
    snap: Optional[_SnapshotCtx] = None
    resume: Optional[DriveSnapshot] = None
    if snapshot_store is not None or resume_from is not None:
        if mesh is not None or axis_name is not None:
            raise ValueError(
                "drive snapshots/resume (snapshot_store=/resume_from=) cover the LOCAL epoch path; mesh/axis_name"
                " epochs keep their own sync semantics — checkpoint the members instead (utils.checkpoint) or"
                " drive locally."
            )
        if snapshot_every is not None and snapshot_every < 1:
            raise ValueError(f"snapshot_every must be >= 1 (or None), got {snapshot_every}")
        resume = _resolve_resume(resume_from, snapshot_key)
        if snapshot_store is not None:
            snap = _SnapshotCtx(snapshot_store, snapshot_every, snapshot_key, type(obj).__name__)
            if resume is not None:
                snap.base_step = resume.step
    if isinstance(axis_name, (tuple, list)):
        axis_name = tuple(axis_name)
    _, members = _members_of(obj)
    if mesh is None and any(m._drive_synced for m in members):
        raise MetricsUserError(
            "This metric holds the globally-synced state of a mesh-mode"
            " engine.drive: a local (non-mesh) drive would accumulate rank-"
            "local steps onto the cross-rank total without syncing them."
            " reset() first, or keep driving with the same axis_name/mesh."
        )

    def run() -> DriveResult:
        if mesh is None:
            return _drive_local(obj, batches, compute_in_trace, steps_per_chunk, snap, resume)
        return _drive_mesh(obj, batches, mesh, axis_name, in_specs, hierarchical_sync, compute_in_trace, steps_per_chunk)

    with torch.no_grad():
        if not _trace.active():
            return run()
        with _trace.span("drive", type(obj).__name__, payload=lambda: [m._snapshot_state() for m in members]):
            return run()


def _bind_states(fused: List[Tuple[str, Any]], states: Dict[str, Any], n_steps: int) -> None:
    for k, m in fused:
        m._restore_state(states[k])
        m._update_count += n_steps
        m._computed = None
        if _health.health_enabled(m):
            m._health_stats["batches_screened"] += n_steps


def _compute_keys(fused: List[Tuple[str, Any]]) -> Tuple[str, ...]:
    from metrics_tpu_torch.parallel import comm

    if comm.distributed_available():
        return ()
    keys = []
    for k, m in fused:
        if (
            m._compute_is_host_side
            or m._is_synced
            or m.dist_sync_fn is not None
            or m._distributed_available_fn is not None
            or m.process_group is not None
        ):
            continue
        ok = m.__dict__.get("_drive_cmp_traceable")
        if ok is None:
            from metrics_tpu_torch.collections import MetricCollection

            ok = m._drive_cmp_traceable = MetricCollection._compute_runs_as_program(m, m._snapshot_state())
        if ok:
            keys.append(k)
    return tuple(keys)


def _step_verdicts(fused: List[Tuple[str, Any]], leaves: List[torch.Tensor]) -> Dict[str, Optional[torch.Tensor]]:
    """For each member whose health policy quarantines a whole update: a
    ``[steps]`` flag, set where the step's whole batch (every process's
    slice) holds a bad element; None for the others."""
    out: Dict[str, Optional[torch.Tensor]] = {}
    floats = [x for x in leaves if x.is_floating_point() or x.is_complex()]
    for key, m in fused:
        out[key] = None
        if not _health.health_enabled(m) or not floats:
            continue
        nan_only = getattr(m, "health_screen", "nonfinite") == "nan"
        flags = [(torch.isnan(x) if nan_only else ~torch.isfinite(x)).reshape(x.shape[0], -1).any(dim=1) for x in floats]
        out[key] = torch.stack(flags).any(dim=0)
    return out


def _drive_mesh(
    obj: Any,
    batches: Any,
    mesh: Any,
    axis_name: Optional[Any],
    in_specs: Optional[Any],
    hierarchical: bool,
    compute_in_trace: bool,
    steps_per_chunk: int,
) -> DriveResult:
    gspmd = in_specs is not None
    keys, members = _members_of(obj)
    stats = _cache.instance_stats(obj)
    stacked = _stacked_steps(batches)
    if stacked is None:
        raise ValueError(
            "drive(mesh=...) needs a stacked epoch (a tuple of tensors with a"
            " leading steps axis): a host iterator cannot be split over the mesh"
            " in one pass."
        )
    ids: Dict[int, int] = {}
    for m in members:
        ids[id(m)] = ids.get(id(m), 0) + 1
    fused = [(k, m) for k, m in zip(keys, members) if ids[id(m)] == 1 and _scan_drivable(m)]
    eager_keys = sorted(k for k, m in zip(keys, members) if (k, m) not in fused)
    # the epoch runs from the defaults and the synced partial states are
    # merged into the prior ones: every state must merge elementwise
    not_mergeable = sorted(k for k, m in fused if not m._states_mergeable)
    if gspmd and eager_keys:
        raise ValueError(
            "drive(mesh=, in_specs=) needs every member scan-drivable —"
            " eager-fallback/list-state/'raise'-policy members cannot"
            " ride the sharded chunks; offending members:"
            f" {eager_keys}. Drive them in a separate local"
            " drive(), or use shard_states(mesh) + per-step updates."
        )
    if not_mergeable or eager_keys:
        raise ValueError(
            "drive(mesh=...) needs every member scan-drivable with"
            " mergeable states (sum/max/min/cat) — the sharded epoch"
            " runs from the defaults and merges the synced delta back;"
            f" offending members: {sorted(set(not_mergeable) | set(eager_keys))}."
        )
    args_tree, n_steps = stacked
    stacked_leaves, _ = _tree.flatten((args_tree, {}))
    if gspmd:
        specs = _shard_reduce.normalize_in_specs(in_specs, len(stacked_leaves))
        axes = _shard_reduce.input_axes(specs)
        for k, m in fused:
            if m._state_shardings and not m._sharded_update:
                raise ValueError(
                    f"drive(mesh=, in_specs=): member {k!r} ({type(m).__name__}) registers sharded states but its"
                    " update is not windowed to a shard (`_sharded_update`); use shard_states(mesh) and per-step"
                    " updates instead."
                )
            split = set(_shard_spec.data_axes(m, mesh)) ^ set(_shard_spec.axis_names(mesh))
            clash = sorted(split & set(axes))
            if clash:
                raise ValueError(
                    f"drive(mesh=, in_specs=): the inputs are split over {clash}, which member {k!r} splits its"
                    " states over; split the batch over the data axes only."
                )
    else:
        axes = tuple(axis_name) if isinstance(axis_name, tuple) else (axis_name,)
        for k, m in fused:
            clash = sorted(a for _, layout in m._shard_layout.items() for _, a in layout.splits if a in axes)
            if clash:
                raise ValueError(
                    f"drive(axis_name=...): member {k!r} splits its states over {clash}; the steps are split over"
                    f" {axes}. Drive it with in_specs= instead."
                )
    if n_steps == 0:
        return DriveResult(0, 0, (), (), obj.compute() if compute_in_trace else None)

    fused_members = [m for _, m in fused]
    step0 = tuple(a[0] for a in args_tree)
    leaves0, treedef = _tree.flatten((step0, {}))
    batched = _bucketing.batched_leaf_indices(leaves0)
    additive_ok = all(_bucketing.supports_bucketing(m) for m in fused_members)
    pads: Optional[List[int]] = None
    share = 1
    verdicts: Dict[str, Optional[torch.Tensor]] = {k: None for k, _ in fused}
    if gspmd:
        for _, m in fused:
            _shard_spec.place_states(m, mesh, source=type(obj).__name__)
        live = [a for a in axes if _comm.axis_world(mesh, a) > 1]
        if live:
            verdicts = _step_verdicts(fused, stacked_leaves)
            share = int(all(mesh.get_local_rank(a) == 0 for a in live))
        local_leaves = _shard_reduce.stage_epoch_inputs(mesh, specs, stacked_leaves)
        local_steps = n_steps
    else:
        world = _comm.axis_world(mesh, axis_name)
        steps = n_steps
        rem = (-steps) % world
        local_leaves = list(stacked_leaves)
        if rem:
            if not additive_ok or not batched:
                raise ValueError(
                    f"drive(mesh=...): {steps} steps do not divide"
                    f" across {world} shards and the members are not"
                    " row-additive over an unambiguous batch axis"
                    " (whole pad steps would not correct exactly);"
                    " pad the epoch or drop mesh mode."
                )
            batch = int(leaves0[batched[0]].shape[0])
            local_leaves = [torch.cat([x, x.new_zeros((rem, *x.shape[1:]))]) for x in local_leaves]
            pads = [0] * steps + [batch] * rem
            steps += rem
        per = steps // world
        start = _comm.axis_index(mesh, axis_name) * per
        local_leaves = [x[start:start + per] for x in local_leaves]
        pads = None if pads is None else pads[start:start + per]
        local_steps = per

    prior = {k: m._snapshot_state() for k, m in fused}
    for _, m in fused:
        m._restore_state(m.init_state())
    extras = {"mesh": mesh, "axes": axes, "hierarchical": hierarchical, "prior": prior, "verdicts": verdicts, "share": share}
    runner = _ChunkRunner(fused, [], stats, (), treedef, batched, additive_ok, steps_per_chunk, mesh=extras)
    try:
        with _comm.axis_env(mesh):
            runner.run_stacked(tuple(local_leaves), local_steps, pads)
            if not runner.synced:
                finish = _mesh_finish(tuple(k for k, _ in fused), mesh, axes, hierarchical)
                merged = finish(fused_members, {k: m._snapshot_state() for k, m in fused}, prior)
                for k, m in fused:
                    m._restore_state(merged[k])
    except BaseException:
        for k, m in fused:
            m._restore_state(prior[k])
        raise
    other_steps = n_steps - local_steps  # every process counts the whole epoch, as JAX does
    for _, m in fused:
        m._update_count += other_steps
        if _health.health_enabled(m):
            m._health_stats["batches_screened"] += other_steps
    stats["mesh_sync"] = "in_program" if runner.synced else "after_program"
    if gspmd:
        fused_keys = tuple(k for k, _ in fused)
        _shard_reduce.constrain_state_tree(
            {k: m._snapshot_state() for k, m in fused}, _shard_reduce.build_constraints(fused_keys, fused_members, mesh)
        )
        _shard_spec.record_drive(fused, mesh)
    if not gspmd or _comm.mesh_spans_processes(mesh):
        # the states are the global accumulation: a host sync in compute()
        # would reduce them again, and a host update would not be synced
        for _, m in fused:
            m._to_sync = False
            m._drive_synced = True
    values = obj.compute() if compute_in_trace else None
    return DriveResult(n_steps, runner.n_chunks, tuple(k for k, _ in fused), (), values)


def drive_bank(bank: Any, tenant: Any, batches: Any) -> int:
    """Fold one tenant's whole epoch into its
    :class:`~metrics_tpu_torch.serving.MetricBank` row in one program:
    ``batches`` is a sequence of per-step update-argument tuples, stacked on
    a steps axis and applied in order by the bank's ``bank_drive`` program
    (a CUDA graph on the card), bit-identical to flushing the steps one at a
    time. Delegates to ``bank.drive``, which states the constraints (one
    step structure; ragged batch sizes need ``jit_bucket="pow2"``;
    collection banks are fed through waves instead). Returns the steps
    applied."""
    return bank.drive(tenant, batches)


def _drive_local(
    obj: Any,
    batches: Any,
    compute_in_trace: bool,
    steps_per_chunk: int,
    snap: Optional[_SnapshotCtx] = None,
    resume: Optional[DriveSnapshot] = None,
) -> DriveResult:
    keys, members = _members_of(obj)
    stats = _cache.instance_stats(obj)
    ids: Dict[int, int] = {}
    for m in members:
        ids[id(m)] = ids.get(id(m), 0) + 1
    fused = [(k, m) for k, m in zip(keys, members) if ids[id(m)] == 1 and _scan_drivable(m)]
    fused_keys = {k for k, _ in fused}
    eager = [(k, m) for k, m in zip(keys, members) if k not in fused_keys]
    if (snap is not None or resume is not None) and eager:
        _raise_not_snapshotable(tuple(k for k, _ in eager))

    def done_early() -> DriveResult:
        # nothing left to run: a resume of a completed epoch binds it; an
        # empty epoch still seals its final snapshot, so a uniform restart's
        # drive(resume_from=) finds one
        if resume is not None:
            _bind_resume(fused, resume, type(obj).__name__)
            return DriveResult(0, 0, tuple(k for k, _ in fused), (), obj.compute() if compute_in_trace else None)
        if snap is not None:
            snap.stage(fused, {k: m._snapshot_state() for k, m in fused}, 0, final=True)
        return DriveResult(
            0, 0, (), tuple(k for k, _ in eager), obj.compute() if compute_in_trace else None,
            snap.written if snap is not None else 0,
        )

    stacked = _stacked_steps(batches)
    if stacked is not None:
        args_tree, n_steps = stacked
        if resume is not None:
            if resume.step > n_steps:
                raise MetricsUserError(
                    f"drive(resume_from=): the snapshot was taken at step {resume.step} but the epoch holds only"
                    f" {n_steps} steps — resume must replay the SAME epoch the snapshot interrupted."
                )
            args_tree = tuple(a[resume.step:] for a in args_tree)
            n_steps -= resume.step
        if n_steps == 0:
            return done_early()
        step_iter: Any = iter(tuple(a[i] for a in args_tree) for i in range(n_steps))
    else:
        step_iter = _steps_iter(batches)
        if resume is not None:
            for skipped in range(resume.step):
                if next(step_iter, None) is None:
                    raise MetricsUserError(
                        f"drive(resume_from=): the stream ended after {skipped} steps but the snapshot was taken at"
                        f" step {resume.step} — resume must replay the SAME epoch the snapshot interrupted."
                    )
    step0 = next(step_iter, None)
    if step0 is None:
        return done_early()
    if resume is not None:
        # the snapshot's states are where the remaining steps start
        _bind_resume(fused, resume, type(obj).__name__)

    fused_members = [m for _, m in fused]
    additive_ok = bool(fused) and all(_bucketing.supports_bucketing(m) for m in fused_members)
    leaves0, treedef = _tree.flatten((step0, {}))
    batched = _bucketing.batched_leaf_indices(leaves0)
    compute_keys = _compute_keys(fused) if compute_in_trace and fused else ()

    chunk = steps_per_chunk
    if stacked is not None and snap is not None and snap.every is not None:
        chunk = min(chunk, snap.every)  # a snapshot at each chunk boundary
    runner = _ChunkRunner(fused, eager, stats, compute_keys, treedef, batched, additive_ok, chunk, snap=snap)
    if stacked is not None and fused:
        runner.run_stacked(args_tree, n_steps)
    else:
        runner.run_stream(step0, step_iter)
    values = None
    if compute_in_trace:
        for k, m in fused:
            if k in runner.values:
                m._computed = _squeeze_if_scalar(runner.values[k])
                if _health.health_enabled(m):
                    _health.check_compute_result(m, m._computed)
        values = obj.compute()
    if snap is not None:
        # from the bound states: they hold the per-step tail updates too,
        # and make a resume of the completed epoch a no-op
        snap.stage(fused, {k: m._snapshot_state() for k, m in fused}, runner.n_steps, final=True)
    return DriveResult(
        runner.n_steps, runner.n_chunks, tuple(k for k, _ in runner.fused), tuple(k for k, _ in runner.eager), values,
        snap.written if snap is not None else 0,
    )


class _ChunkRunner:
    """Drives the fused members chunk by chunk and the eager ones step by
    step. On a fallback error the states reached so far are bound and the
    remaining steps (the failed chunk's included) run per step."""

    def __init__(self, fused, eager, stats, compute_keys, treedef, batched, additive_ok, k, mesh=None, snap=None) -> None:
        """``mesh``: a mesh drive's ``{"mesh", "axes", "hierarchical",
        "prior", "verdicts", "share"}``; its chunks run the ``mesh_scan``
        programs with the quarantine verdicts, the last one with the sync
        and the merge into ``prior`` where the backend's collectives capture
        (NCCL). ``snap``: the drive's snapshot writer, staged at the chunk
        boundaries it finds due."""
        self.snap = snap
        self.fused = list(fused)
        self.eager = list(eager)
        self.stats = stats
        self.compute_keys = compute_keys
        self.treedef = treedef
        self.batched = batched
        self.additive_ok = additive_ok
        self.k = k
        mesh_sync = None if mesh is None else (mesh["mesh"], mesh["axes"], mesh["hierarchical"])
        self.entry = (
            _driver_entry(tuple(k_ for k_, _ in fused), [m for _, m in fused], compute_keys, mesh_sync)
            if fused
            else None
        )
        self.states = {key: m._snapshot_state() for key, m in fused}
        self.values: Dict[str, Any] = {}
        self.n_steps = 0
        self.n_chunks = 0
        self.bound_steps = 0  # steps the carried states hold
        self.moved: List[Any] = []  # fused members sent per step by a fallback
        self.staging: Optional[_Staging] = None
        self.mesh = mesh
        if mesh is not None:
            live = _comm.live_axes(mesh["mesh"], mesh["axes"])
            mesh["in_program"] = all(_comm._in_program_backend(_comm.axis_group(mesh["mesh"], a)) for a in live)
        self.synced = False  # the last chunk's program ran the mesh sync

    # -- chunks -----------------------------------------------------------
    def _boundary(self, steps_done: int) -> None:
        if self.snap is not None and self.snap.due(steps_done):
            self.snap.stage(self.fused, self.states, steps_done, final=False)

    def _dispatch_mesh(self, leaves: List[torch.Tensor], pads: Optional[List[int]], last: bool, pos: int) -> None:
        members = [m for _, m in self.fused]
        k = int(leaves[0].shape[0])
        device = leaves[0].device
        bad = {
            key: None if v is None else _pad_flags(v[pos:pos + k], k)
            for key, v in self.mesh["verdicts"].items()
        }
        pad_t = None if pads is None else _device_pads(pads, device)
        extra: Dict[str, Any] = {"bad": bad, "share": self.mesh["share"]}
        sync = last and self.mesh["in_program"]
        if sync:
            extra["prior"] = self.mesh["prior"]
        probe = not _cache.probed(members)
        try:
            out = self.entry.invoke(
                "mesh_scan_sync" if sync else "mesh_scan", members, self.stats, self.states, leaves, pad_t, self.treedef,
                extra, probe=probe,
            )
        except _cache.FALLBACK_ERRORS:
            if not sync:
                raise
            # the collectives would not capture: the sync runs after the program
            self.mesh["in_program"] = False
            sync = False
            extra.pop("prior")
            out = self.entry.invoke(
                "mesh_scan", members, self.stats, self.states, leaves, pad_t, self.treedef, extra, probe=probe
            )
        _cache.mark_probed(members)
        self.states = out
        self.synced = sync
        self.n_chunks += 1

    def _dispatch(self, leaves: List[torch.Tensor], pads: Optional[List[int]], last: bool, pos: int = 0) -> None:
        if self.mesh is not None:
            self._dispatch_mesh(leaves, pads, last, pos)
            return
        members = [m for _, m in self.fused]
        cmp = last and bool(self.compute_keys)
        variant = ("scan_pad" if pads is not None else "scan") + ("_cmp" if cmp else "")
        inputs: Tuple[Any, ...] = (self.states, leaves)
        if pads is not None:
            inputs += (torch.tensor(pads, dtype=torch.int64).to(leaves[0].device),)
        inputs += (self.treedef,)
        probe = not _cache.probed(members)
        try:
            out = self.entry.invoke(variant, members, self.stats, *inputs, probe=probe)
        except _cache.FALLBACK_ERRORS:
            if not cmp:
                raise
            # the computes would not capture: this chunk without them, and
            # the values from the host afterwards
            self.compute_keys = ()
            variant = variant[: -len("_cmp")]
            out = self.entry.invoke(variant, members, self.stats, *inputs, probe=probe)
            cmp = False
        _cache.mark_probed(members)
        if cmp:
            self.states, self.values = out
        else:
            self.states = out
        self.n_chunks += 1

    # -- stacked epochs ------------------------------------------------------
    def run_stacked(self, args_tree: Tuple[torch.Tensor, ...], n_steps: int, step_pads: Optional[List[int]] = None) -> None:
        """``step_pads``: the pad rows of each step (a mesh drive's whole
        zero steps), None for none."""
        stacked_leaves, _ = _tree.flatten((args_tree, {}))
        k = min(self.k, n_steps)
        batch = int(stacked_leaves[self.batched[0]].shape[1]) if self.batched else 0
        pos = 0
        while pos < n_steps:
            span = min(k, n_steps - pos)
            chunk = [x[pos:pos + span] for x in stacked_leaves]
            pads = None if step_pads is None or not any(step_pads[pos:pos + span]) else list(step_pads[pos:pos + span])
            if span < k and self.additive_ok and self.batched:
                # whole zero steps, so the K-step program replays again
                chunk = [torch.cat([x, x.new_zeros((k - span, *x.shape[1:]))]) for x in chunk]
                pads = (pads or [0] * span) + [batch] * (k - span)
            last = pos + span >= n_steps
            try:
                self._dispatch(chunk, pads, last, pos)
            except _cache.FALLBACK_ERRORS:
                self._fall_back_from(pos, n_steps, lambda i: tuple(a[i] for a in args_tree), step_pads)
                return
            pos += span
            self.bound_steps = pos
            if not last:
                self._boundary(pos)
        self.n_steps = n_steps
        _bind_states(self.fused, self.states, n_steps)
        for i in range(n_steps):
            for _, m in self.eager:
                m.update(*tuple(a[i] for a in args_tree))

    def _fall_back_from(self, pos: int, n_steps: int, step_at: Any, step_pads: Optional[List[int]] = None) -> None:
        new_eager = list(self.fused)
        _bind_states(self.fused, self.states, pos)
        for _, m in new_eager:
            m._jit_failed = True
        old_eager = list(self.eager)
        self.eager = old_eager + new_eager
        self.fused = []
        for i in range(n_steps):
            if step_pads is not None and step_pads[i]:
                continue  # a whole zero step a mesh drive appended
            for _, m in (new_eager if i >= pos else []) + old_eager:
                m.update(*step_at(i))
        self.n_steps = n_steps
        self.values = {}

    # -- host iterables ------------------------------------------------------
    def _stage(self, steps: List[List[Any]]) -> Tuple[List[torch.Tensor], Optional[Dict[str, Any]]]:
        cols = [[_as_step_tensor(x) for x in col] for col in zip(*steps)]
        device = next((m.device for _, m in self.fused), torch.device("cpu"))
        if device.type == "cuda" and all(x.device.type == "cpu" for col in cols for x in col):
            if self.staging is None:
                self.staging = _Staging(device)
            dev, slot = self.staging.stage([list(s) for s in zip(*cols)])
            torch.cuda.current_stream(device).wait_event(slot["copied"])
            return dev, slot
        return [torch.stack([x.to(device) for x in col]) for col in cols], None

    def run_stream(self, step0: Tuple[Any, ...], step_iter: Any) -> None:
        chunk_sig: Optional[Tuple] = None
        chunk_leaves0: Optional[List[Any]] = None
        chunk_steps: List[List[Any]] = []
        chunk_args: List[Tuple[Any, ...]] = []
        chunk_pads: List[int] = []
        family_full = 0
        tail_steps: List[Tuple[Any, ...]] = []
        # the chunk parked until the next is staged, so the last one can take
        # the *_cmp variant
        pending: Optional[Tuple[List[torch.Tensor], Optional[List[int]], Any, List[Tuple[Any, ...]]]] = None

        def _run(staged, last: bool) -> bool:
            leaves, pads, slot, args_list = staged
            try:
                self._dispatch(leaves, pads, last)
            except _cache.FALLBACK_ERRORS:
                self._stream_fallback(args_list)
                return False
            if slot is not None:
                _Staging.consumed(slot)
            self.bound_steps += len(args_list)
            if not last and not tail_steps:
                # the states hold exactly the first bound_steps stream items
                self._boundary(self.bound_steps)
            return True

        def _flush(last: bool) -> None:
            nonlocal pending, chunk_steps, chunk_args, chunk_pads
            if chunk_steps:
                leaves, slot = self._stage(chunk_steps)
                staged = (leaves, chunk_pads if any(chunk_pads) else None, slot, chunk_args)
                chunk_steps, chunk_args, chunk_pads = [], [], []
                if not self.compute_keys:
                    if self.fused:
                        _run(staged, last)
                    else:
                        self._per_step(staged[3])
                    staged = None
                elif pending is not None:
                    if self.fused:
                        _run(pending, False)
                    else:
                        self._per_step(pending[3])
                if staged is not None:
                    pending = staged
            if last and pending is not None:
                if self.fused:
                    _run(pending, not tail_steps)
                else:
                    self._per_step(pending[3])
                pending = None

        for step_args in _chain(step0, step_iter):
            self.n_steps += 1
            for _, m in self.eager:
                m.update(*step_args)
            if not self.fused:
                continue
            leaves, step_treedef = _tree.flatten((step_args, {}))
            if step_treedef != self.treedef:
                tail_steps.append(step_args)
                continue
            sig = _step_sig(leaves, step_treedef)
            if chunk_sig is None or sig != chunk_sig:
                folded = None
                if chunk_sig is not None and self.additive_ok:
                    folded = _ragged_pad(leaves, chunk_leaves0, step_treedef, self.treedef, self.batched)
                if folded is not None:
                    chunk_steps.append(folded[0])
                    chunk_args.append(step_args)
                    chunk_pads.append(folded[1])
                    if len(chunk_steps) >= self.k:
                        family_full += 1
                        _flush(False)
                    continue
                if chunk_sig is not None:
                    _flush(False)
                    family_full = 0
                chunk_sig, chunk_leaves0 = sig, list(leaves)
            chunk_steps.append(list(leaves))
            chunk_args.append(step_args)
            chunk_pads.append(0)
            if len(chunk_steps) >= self.k:
                family_full += 1
                _flush(False)
        if (
            self.fused
            and chunk_steps
            and self.additive_ok
            and self.batched
            and len(chunk_steps) < self.k
            and family_full > 0
        ):
            # pad the short final chunk with whole zero steps so the K-step
            # program replays again
            batch = int(chunk_leaves0[self.batched[0]].shape[0])
            zero_step = [
                torch.zeros_like(_as_step_tensor(x)) if i in set(self.batched) else x
                for i, x in enumerate(chunk_leaves0)
            ]
            while len(chunk_steps) < self.k:
                chunk_steps.append(list(zero_step))
                chunk_pads.append(batch)
        _flush(True)
        if self.fused:
            _bind_states(self.fused, self.states, self.bound_steps)
            for step_args in tail_steps:
                for _, m in self.fused:
                    m.update(*step_args)
            if tail_steps:
                self.values = {}

    def _per_step(self, args_list: List[Tuple[Any, ...]]) -> None:
        """Steps staged before a fallback, for the members it moved."""
        for step_args in args_list:
            for _, m in self.moved:
                m.update(*step_args)

    def _stream_fallback(self, args_list: List[Tuple[Any, ...]]) -> None:
        """A chunk could not run as a program: bind the states so far, then
        the fused members go per step, this chunk's steps first."""
        _bind_states(self.fused, self.states, self.bound_steps)
        for _, m in self.fused:
            m._jit_failed = True
        self.moved = self.fused
        self.fused = []
        self.eager.extend(self.moved)
        self.values = {}
        self._per_step(args_list)


def _device_pads(pads: List[int], device: torch.device) -> torch.Tensor:
    """A chunk's pad rows per step on ``device``. A mesh drive pads whole
    zero steps at the end (``[0, ..., 0, b, ..., b]``): two fills, where a
    copy from a host list would be a host sync."""
    j = sum(1 for p in pads if p == 0)
    tail = set(pads[j:])
    if any(pads[:j]) or len(tail) > 1:
        return torch.tensor(pads, dtype=torch.int64).to(device)
    out = torch.full((len(pads),), tail.pop() if tail else 0, dtype=torch.int64, device=device)
    out[:j] = 0
    return out


def _pad_flags(flags: torch.Tensor, k: int) -> torch.Tensor:
    """A chunk's ``[k]`` verdicts: the pad steps past the epoch are clean."""
    if flags.shape[0] == k:
        return flags
    return torch.cat([flags, flags.new_zeros(k - flags.shape[0])])


def _chain(first: Tuple[Any, ...], rest: Any):
    yield first
    yield from rest


"""Per-state sharding layout: registration, placement, telemetry
(counterpart of ``metrics_tpu/sharding/spec.py``).

* **Registration.** ``Metric.add_state(..., sharding=PartitionSpec("mp"))``
  annotates an array state with the mesh axes its dimensions are split
  over. The annotation is configuration: it names mesh *axes*, travels with
  the instance through clones, pickles, checkpoints and resets, and binds
  to a concrete :class:`torch.distributed.device_mesh.DeviceMesh` only at
  placement. :class:`PartitionSpec` is the port's own, a tuple of entries
  (``None``, an axis name, or a tuple of names) with the JAX class's
  equality, ``len`` and ``str``.
* **Placement.** :func:`place_states` (``Metric.shard_states(mesh)``) and
  ``engine.drive(mesh=, in_specs=)`` lay a metric out over a mesh: one
  process per device, and each process keeps only its shard. A dimension
  named by the spec is split over the named mesh axis in
  ``torch.chunk`` order (``Shard(i)``); the other mesh axes hold replicas
  (``Replicate()``). The state at rest is that local shard, a plain
  tensor, with the layout recorded on the metric (``_shard_layout``): the
  kernel wrappers hand ``data_ptr()`` to ``ctypes`` launches, and a
  ``DTensor`` is a wrapper subclass without storage (its ``data_ptr()`` is
  0), so the engine's programs, static buffers and kernels work on local
  shards only. :meth:`Metric.sharded_state` gives the ``DTensor`` view of a
  placed state (no copy), whose placements :func:`spec_of_value` reads.
  Only the local shard is resident: the registered default is sliced too.
* **Telemetry.** :func:`shard_stats` (``obs.snapshot()["sharding"]`` and
  the ``metrics_tpu_shard_*`` Prometheus families) counts sharded drives,
  reshard events (state leaves laid out anew) and mesh changes, and keeps
  the registered specs and the per-device resident bytes of each sharded
  state, under the JAX package's keys. While the event bus records, a
  placement that moves leaves emits one ``reshard`` event.

Placement splits a state dimension over one mesh axis; a dimension named
with a tuple of axes registers (as in the JAX package) but raises at
placement. An encoder's parameter leaves (``ShardedEncoder(param_specs=)``)
are validated, laid out and gathered by the same functions
(:func:`normalize_state_sharding`, :func:`layout_of`, :func:`local_slice`,
:func:`gather_state`).
"""
import threading
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from metrics_tpu_torch.utils.exceptions import MetricsUserError

__all__ = [
    "PartitionSpec",
    "ShardLayout",
    "StateSpec",
    "canonical_spec",
    "class_axis_spec",
    "count_mesh_change",
    "count_sharded_drive",
    "gather_state",
    "global_view",
    "normalize_state_sharding",
    "place_state_dict",
    "place_states",
    "record_drive",
    "reset_shard_stats",
    "shard_stats",
    "sharding_conflict",
    "spec_of_value",
]


class PartitionSpec(tuple):
    """A tuple of mesh-axis entries, one per leading state dimension:
    ``None`` (not split), an axis name, or a tuple of names. Equal to the
    tuple of its entries, so ``P("mp") != P("mp", None)``, as in JAX;
    :func:`canonical_spec` unifies them."""

    def __new__(cls, *entries: Any) -> "PartitionSpec":
        return super().__new__(cls, entries)

    def __getnewargs__(self) -> Tuple[Any, ...]:
        return tuple(self)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


class StateSpec(NamedTuple):
    """An array state's global ``shape``, ``dtype`` and registered
    ``sharding`` (a :class:`PartitionSpec`, or None for a state that is not
    split): what :meth:`Metric.state_spec` returns."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    sharding: Optional[PartitionSpec] = None


class ShardLayout(NamedTuple):
    """Where one placed state's local shard sits in the global state."""

    spec: PartitionSpec
    global_shape: Tuple[int, ...]
    offsets: Tuple[int, ...]
    local_shape: Tuple[int, ...]
    #: ``(tensor dim, mesh axis name)`` for each split dimension
    splits: Tuple[Tuple[int, str], ...]


def normalize_state_sharding(name: str, sharding: Any, default: Any) -> PartitionSpec:
    """Validate and canonicalize one ``add_state(sharding=)`` annotation: a
    :class:`PartitionSpec`, a bare axis name (``"mp"``, the leading axis
    split over it) or a tuple of entries. List states cannot be split, and
    the spec may not name more dimensions than the default has."""
    if isinstance(default, list):
        raise ValueError(
            f"`sharding` for state {name!r}: list ('cat' buffer) states cannot"
            " carry a sharding annotation — only array states have a stable"
            " layout to shard."
        )
    if isinstance(sharding, str):
        sharding = PartitionSpec(sharding)
    elif isinstance(sharding, tuple) and not isinstance(sharding, PartitionSpec):
        sharding = PartitionSpec(*sharding)
    if not isinstance(sharding, PartitionSpec):
        raise ValueError(
            f"`sharding` for state {name!r} must be a PartitionSpec"
            f" (or a mesh-axis name / tuple of entries), got {sharding!r}"
        )
    ndim = torch.as_tensor(default).ndim
    if len(sharding) > ndim:
        raise ValueError(
            f"`sharding` for state {name!r} names {len(sharding)} dimensions"
            f" but the registered default has rank {ndim}: {sharding}"
        )
    return sharding


def canonical_spec(spec: Optional[PartitionSpec]) -> Tuple:
    """Hashable canonical form: trailing ``None`` entries trimmed."""
    if spec is None:
        return ()
    entries = tuple(spec)
    while entries and entries[-1] is None:
        entries = entries[:-1]
    return entries


def class_axis_spec(class_sharding: Any) -> Optional[PartitionSpec]:
    """A classification metric's ``class_sharding`` (None, an axis name or a
    :class:`PartitionSpec`) as the spec of a leading-class-axis state."""
    if class_sharding is None:
        return None
    if isinstance(class_sharding, PartitionSpec):
        return class_sharding
    if isinstance(class_sharding, str):
        return PartitionSpec(class_sharding)
    raise ValueError(
        "`class_sharding` must be a mesh-axis name (e.g. 'mp') or a"
        f" PartitionSpec, got {class_sharding!r}"
    )


# ---------------------------------------------------------------------------
# layouts on a DeviceMesh
# ---------------------------------------------------------------------------
def axis_names(mesh: Any) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    if not names:
        raise MetricsUserError("a sharded-state mesh needs named dims: init_device_mesh(..., mesh_dim_names=(...))")
    return tuple(names)


def axis_size(mesh: Any, axis: str) -> int:
    return int(mesh.shape[axis_names(mesh).index(axis)])


def _chunk(n: int, k: int, c: int) -> Tuple[int, int]:
    """``(offset, length)`` of chunk ``c`` of ``k`` of a length-``n`` axis,
    as ``torch.chunk`` splits it (chunks of ``ceil(n / k)``, the last ones
    shorter or empty)."""
    size = -(-n // k) if n else 0
    start = min(c * size, n)
    return start, max(0, min(size, n - start))


def layout_of(mesh: Any, spec: PartitionSpec, shape: Tuple[int, ...], name: str = "") -> ShardLayout:
    """This process's shard of a ``shape`` state laid out by ``spec``."""
    coords = {axis: int(mesh.get_local_rank(axis)) for axis in axis_names(mesh)}
    return layout_at(mesh, spec, shape, coords, name)


def layout_at(mesh: Any, spec: PartitionSpec, shape: Tuple[int, ...], coords: Dict[str, int], name: str = "") -> ShardLayout:
    """The shard of a ``shape`` state laid out by ``spec`` that the process
    at mesh coordinates ``coords`` (axis name -> index) holds: what
    :func:`layout_of` gives that process, computed anywhere (a read
    exchange places every process's rows by it)."""
    names = axis_names(mesh)
    offsets, local, splits = [0] * len(shape), list(shape), []
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        if len(axes) != 1:
            raise MetricsUserError(
                f"state {name!r}: dimension {dim} is split over the mesh axes {axes}; the port places a state"
                " dimension over one mesh axis."
            )
        axis = axes[0]
        if axis not in names:
            raise MetricsUserError(f"state {name!r} is registered with axis {axis!r}, which the mesh {names} lacks")
        offsets[dim], local[dim] = _chunk(int(shape[dim]), axis_size(mesh, axis), int(coords[axis]))
        splits.append((dim, axis))
    return ShardLayout(spec, tuple(shape), tuple(offsets), tuple(local), tuple(splits))


def placements_of(mesh: Any, layout: ShardLayout) -> List[Any]:
    from torch.distributed.tensor import Replicate, Shard

    by_axis = {axis: dim for dim, axis in layout.splits}
    return [Shard(by_axis[a]) if a in by_axis else Replicate() for a in axis_names(mesh)]


def local_slice(value: torch.Tensor, layout: ShardLayout) -> torch.Tensor:
    """This process's shard of the global ``value`` (a copy of its own)."""
    out = value
    for dim, _ in layout.splits:
        out = out.narrow(dim, layout.offsets[dim], layout.local_shape[dim])
    return out.clone()


def gather_state(value: torch.Tensor, layout: ShardLayout, mesh: Any, in_program: bool = False) -> torch.Tensor:
    """The global state from every process's shard: one ``all_gather`` over
    each split dimension's mesh axis (shards padded to the chunk length, and
    the padding cut off), a collective every process of the mesh makes.
    ``in_program``: the gathers run as the programs' collectives do
    (``comm.reduce_in_trace``: on NCCL the functional collective, which a
    CUDA graph captures, also over an axis of one process)."""
    from metrics_tpu_torch.parallel import comm

    out = value
    for dim, axis in layout.splits:
        k = axis_size(mesh, axis)
        n = layout.global_shape[dim]
        live = axis in comm.live_axes(mesh, (axis,)) if in_program else k > 1
        if not live:
            continue
        size = -(-n // k)
        if out.shape[dim] < size:
            pad = list(out.shape)
            pad[dim] = size - out.shape[dim]
            out = torch.cat([out, out.new_zeros(pad)], dim=dim)
        if in_program:
            parts = list(comm.reduce_in_trace(out, None, axis, mesh=mesh).unbind(0))
        else:
            parts = [torch.empty_like(out) for _ in range(k)]
            dist.all_gather(parts, out.contiguous(), group=mesh.get_group(axis))
        out = torch.cat(parts, dim=dim).narrow(dim, 0, n)
    return out


def dtensor_view(value: torch.Tensor, layout: ShardLayout, mesh: Any) -> Any:
    """The ``DTensor`` of a placed state: its local shard, no copy."""
    from torch.distributed.tensor import DTensor

    stride, acc = [], 1
    for n in reversed(layout.global_shape):
        stride.insert(0, acc)
        acc *= max(int(n), 1)
    return DTensor.from_local(
        value, mesh, placements_of(mesh, layout), run_check=False, shape=torch.Size(layout.global_shape),
        stride=tuple(stride),
    )


def spec_of_value(value: Any) -> Optional[PartitionSpec]:
    """The :class:`PartitionSpec` a ``DTensor`` is laid out with (its
    ``Shard`` placements by mesh-axis name), or None when it is not split
    (replicated, or not a ``DTensor``)."""
    placements = getattr(value, "placements", None)
    mesh = getattr(value, "device_mesh", None)
    if placements is None or mesh is None:
        return None
    entries: List[Any] = [None] * value.ndim
    for axis, placement in zip(mesh.mesh_dim_names or (), placements):
        dim = getattr(placement, "dim", None)
        if dim is None:
            continue
        entries[dim] = axis if entries[dim] is None else tuple(
            (entries[dim],) if isinstance(entries[dim], str) else entries[dim]
        ) + (axis,)
    spec = PartitionSpec(*canonical_spec(PartitionSpec(*entries)))
    return spec if spec else None


def sharding_conflict(registered: PartitionSpec, bound: Any) -> Optional[str]:
    """None when a bound value's live layout is compatible with the
    registered spec (not split, or split exactly as registered), else what
    conflicts."""
    live = spec_of_value(bound)
    if live is None:
        return None
    if canonical_spec(live) != canonical_spec(registered):
        return f"laid out as {live} but registered with sharding {registered}"
    return None


# ---------------------------------------------------------------------------
# process-wide telemetry (obs.snapshot()["sharding"], metrics_tpu_shard_*)
# ---------------------------------------------------------------------------
_STATS_LOCK = threading.Lock()


def _new_stats() -> Dict[str, Any]:
    return {
        # engine.drive(mesh=, in_specs=) epochs run with sharded states
        "sharded_drives": 0,
        # state leaves laid out anew on a mesh (place_states, drive staging)
        "reshard_events": 0,
        # a placed metric laid out over another mesh
        "mesh_changes": 0,
        # "Class.state" -> str(PartitionSpec)
        "specs": {},
        # "Class.state" -> {per_device_bytes, total_bytes, devices}
        "resident": {},
    }


_STATS = _new_stats()


def shard_stats() -> Dict[str, Any]:
    """Process-wide sharded-state telemetry (see the module docstring)."""
    with _STATS_LOCK:
        out = dict(_STATS)
        out["specs"] = dict(_STATS["specs"])
        out["resident"] = {k: dict(v) for k, v in _STATS["resident"].items()}
    return out


def reset_shard_stats() -> None:
    with _STATS_LOCK:
        _STATS.clear()
        _STATS.update(_new_stats())


def _record_resident(state_key: str, layout: ShardLayout, value: torch.Tensor, mesh: Any) -> None:
    total = value.element_size()
    for n in layout.global_shape:
        total *= int(n)
    with _STATS_LOCK:
        _STATS["specs"][state_key] = str(layout.spec)
        _STATS["resident"][state_key] = {
            "per_device_bytes": int(value.numel() * value.element_size()),
            "total_bytes": int(total),
            "devices": int(mesh.size()),
        }


def _count_reshard(n: int, source: str, mesh: Any) -> None:
    if n <= 0:
        return
    with _STATS_LOCK:
        _STATS["reshard_events"] += n
    from metrics_tpu_torch.obs import bus as _bus

    if _bus.enabled():
        _bus.emit("reshard", source=source, leaves=n, mesh_axes={a: axis_size(mesh, a) for a in axis_names(mesh)})


def count_sharded_drive() -> None:
    with _STATS_LOCK:
        _STATS["sharded_drives"] += 1


def count_mesh_change() -> None:
    with _STATS_LOCK:
        _STATS["mesh_changes"] += 1


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------
def registered_shape(metric: Any, name: str) -> Tuple[int, ...]:
    """A state's registered (global) shape, placed or not."""
    layout = metric.__dict__.get("_shard_layout", {}).get(name)
    return layout.global_shape if layout is not None else tuple(metric._defaults[name].shape)


def local_value(metric: Any, name: str, value: Any) -> torch.Tensor:
    """``value`` for state ``name`` as this process holds it, on the
    metric's device: a ``DTensor`` in the metric's own layout as its local
    shard, any other ``DTensor`` gathered; then, for a placed state, a
    global value sliced to the shard (a value of the shard's shape is taken
    as the shard)."""
    layout = (metric.__dict__.get("_shard_layout") or {}).get(name)
    if getattr(value, "placements", None) is not None:
        mine = (
            layout is not None
            and getattr(value, "device_mesh", None) is metric.__dict__.get("_shard_mesh")
            and canonical_spec(spec_of_value(value)) == canonical_spec(layout.spec)
        )
        value = value.to_local() if mine else value.full_tensor()
        if mine:
            return value.to(metric.device)
    t = torch.as_tensor(value, device=metric.device)
    if layout is not None and tuple(t.shape) == layout.global_shape and layout.global_shape != layout.local_shape:
        t = local_slice(t, layout)
    return t


def mark_global(metric: Any) -> None:
    """A placed metric given global states (a checkpoint tree, a global
    ``state_dict``) holds what a mesh drive's sync leaves: on a mesh of more
    than one process its host sync and data-axis reduction are disarmed and
    host updates raise until ``reset()``, as after such a drive."""
    from metrics_tpu_torch.parallel.comm import mesh_spans_processes

    if metric.__dict__.get("_shard_layout") and mesh_spans_processes(metric._shard_mesh):
        metric._to_sync = False
        metric._drive_synced = True


def is_global_value(metric: Any, name: str, value: Any) -> bool:
    """Whether ``value`` is the global value of placed state ``name`` (not its shard)."""
    layout = (metric.__dict__.get("_shard_layout") or {}).get(name)
    if layout is None or getattr(value, "placements", None) is not None:
        return False
    shape = tuple(getattr(value, "shape", ()))
    return shape == layout.global_shape and layout.global_shape != layout.local_shape


def place_state_dict(
    state: Dict[str, Any], metric: Any, mesh: Any, source: Optional[str] = None
) -> Tuple[Dict[str, Any], Dict[str, ShardLayout]]:
    """One state dict of ``metric`` laid out over ``mesh`` by its registered
    specs: ``(state, layouts)``. A global value is sliced to this process's
    shard; a shard of the same layout stays; a shard of another mesh is
    gathered and sliced anew. Records the resident bytes and the reshard
    events."""
    shardings = metric.__dict__.get("_state_shardings") or {}
    current = metric.__dict__.get("_shard_layout") or {}
    cls = type(metric).__name__
    out = dict(state)
    layouts: Dict[str, ShardLayout] = {}
    moved = 0
    for name, spec in shardings.items():
        value = out.get(name)
        if value is None or isinstance(value, list):
            continue
        layout = layout_of(mesh, spec, registered_shape(metric, name), f"{cls}.{name}")
        old = current.get(name)
        same_mesh = metric.__dict__.get("_shard_mesh") is mesh
        if not (old == layout and same_mesh and tuple(value.shape) == layout.local_shape):
            if old is not None and tuple(value.shape) == old.local_shape and old.splits:
                value = gather_state(value, old, metric._shard_mesh)
            value = local_slice(value, layout)
            moved += 1
        out[name] = value
        layouts[name] = layout
        _record_resident(f"{cls}.{name}", layout, value, mesh)
    _count_reshard(moved, source or cls, mesh)
    return out, layouts


def place_states(metric: Any, mesh: Any, source: Optional[str] = None, count_change: bool = True) -> Any:
    """Lay a metric's registered-sharded states out over ``mesh``, its
    defaults too (so :meth:`Metric.reset` gives placed defaults), and
    remember the mesh and layouts: the body of ``Metric.shard_states``.
    A new layout changes the program, so the metric's program key is made
    anew. ``count_change=False`` leaves ``mesh_changes`` to the caller
    (``fleet.reshard_onto`` counts each move once, placed before or not)."""
    if not metric.__dict__.get("_state_shardings"):
        metric._shard_mesh = mesh
        return metric
    old_mesh = metric.__dict__.get("_shard_mesh")
    if count_change and old_mesh is not None and old_mesh is not mesh:
        count_mesh_change()
    placed, layouts = place_state_dict(metric._snapshot_state(), metric, mesh, source)
    defaults = dict(metric._defaults)
    for name, layout in layouts.items():
        old = (metric.__dict__.get("_shard_layout") or {}).get(name)
        if old is not None and old == layout and old_mesh is mesh:
            continue
        default = defaults[name]
        if old is not None:
            default = gather_state(default, old, old_mesh)
        defaults[name] = local_slice(default, layout)
    changed = layouts != (metric.__dict__.get("_shard_layout") or {}) or old_mesh is not mesh
    metric._defaults = defaults
    metric._restore_state(placed)
    metric._shard_layout = layouts
    metric._shard_mesh = mesh
    if changed:  # the program key holds the layout (and digests the defaults: a copy to the host)
        metric.__dict__.pop("_engine_key", None)
        metric.__dict__.pop("_engine_key_pins", None)
        metric.__dict__.pop("_zero_row_deltas", None)
    return metric


def unplaced_copy(metric: Any, state: Dict[str, Any]) -> Dict[str, Any]:
    """``state`` (a metric ``__dict__``) with every placed state, its default
    and a sync cache gathered to the global tensors and the placement
    dropped: what a clone or a pickle carries. A collective every process
    of the mesh makes."""
    layouts = state.get("_shard_layout") or {}
    mesh = state.get("_shard_mesh")
    out = dict(state)
    if layouts:
        out["_defaults"] = dict(state["_defaults"])
        out["_buffers"] = dict(state["_buffers"])
        for name, layout in layouts.items():
            out["_defaults"][name] = gather_state(state["_defaults"][name], layout, mesh)
            out["_buffers"][name] = gather_state(state["_buffers"][name], layout, mesh)
    out["_shard_layout"] = {}
    out["_shard_mesh"] = None
    return out


def record_drive(fused: Any, mesh: Any) -> None:
    """After ``drive(mesh=, in_specs=)``: count the sharded epoch and
    refresh the resident bytes of every sharded state it carried."""
    count_sharded_drive()
    for _key, member in fused:
        layouts = member.__dict__.get("_shard_layout") or {}
        for name, layout in layouts.items():
            value = getattr(member, name, None)
            if isinstance(value, torch.Tensor):
                _record_resident(f"{type(member).__name__}.{name}", layout, value, mesh)


def data_axes(metric: Any, mesh: Any) -> Tuple[str, ...]:
    """The mesh axes a placed metric's states are not split over: the
    axes whose processes hold replicas of every state, each fed its own
    batches."""
    named = {axis for layout in (metric.__dict__.get("_shard_layout") or {}).values() for _, axis in layout.splits}
    named |= {
        a
        for spec in (metric.__dict__.get("_state_shardings") or {}).values()
        for e in spec
        if e is not None
        for a in ((e,) if isinstance(e, str) else e)
    }
    return tuple(a for a in axis_names(mesh) if a not in named)


def global_state(metric: Any, state: Dict[str, Any], reduce_data: bool) -> Dict[str, Any]:
    """A placed metric's state as the global one: with ``reduce_data`` every
    state reduced over the data axes first (each by its ``dist_reduce_fx``),
    then every split state gathered."""
    from metrics_tpu_torch.parallel import comm

    mesh = metric._shard_mesh
    out = dict(state)
    axes = data_axes(metric, mesh) if reduce_data else ()
    axes = tuple(a for a in axes if axis_size(mesh, a) > 1)
    if axes:
        out = comm.sync_state_in_trace(
            out, metric._reductions, axes, placeholders=metric._list_placeholders, mesh=mesh
        )
    for name, layout in metric._shard_layout.items():
        if isinstance(out.get(name), torch.Tensor):
            out[name] = gather_state(out[name], layout, mesh)
    return out


@contextmanager
def global_view(metric: Any, reduce_data: bool) -> Iterator[None]:
    """Within the block the placed metric holds its global state (see
    :func:`global_state`); its local shards come back after."""
    saved = metric._snapshot_state()
    metric._restore_state(global_state(metric, saved, reduce_data))
    try:
        yield
    finally:
        metric._restore_state(saved)

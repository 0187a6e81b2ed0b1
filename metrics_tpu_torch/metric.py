"""``Metric`` base class: state registry, lifecycle, cross-process sync and
the update engine (counterpart of ``metrics_tpu/metric.py``).

* A ``Metric`` is an ``nn.Module``. Tensor states are buffers on the
  metric's device; ``cat`` buffers are Python lists of tensors.
* ``device=None`` means the card (``torch.device("cuda")``). Without CUDA
  that raises: the CPU is used only when the caller asks for it.
* States are replaced, never written in place, so a snapshot of the state
  dict is a set of references.
* ``forward`` computes the batch delta once on fresh state and merges it
  into the accumulated state with each state's ``dist_reduce_fx``.
* The pure API (``init_state``/``update_state``/``compute_state``/
  ``merge_states``) runs the same update and compute on explicit state dicts.
* ``copy.deepcopy``, ``pickle`` and ``clone`` give a metric with its own
  state and its own ``update``/``compute`` wrappers; states keep their device.
  A ``torch.distributed`` process group is a process-local handle: a deep
  copy shares it, and pickling leaves it out; a store-backed
  ``parallel.ProcessGroup`` is a plain record and pickles with its ranks.
* ``compute`` syncs: every state is gathered from the ranks of the process
  group and reduced by its ``dist_reduce_fx`` before the value is computed,
  and the local state comes back afterwards (``sync``/``unsync``).
  ``on_sync_error`` says what a failed sync does, and ``add_state(
  sync_precision=)`` lets a float state travel as bf16 or int8 codes.
* Arithmetic and comparison operators on metrics build a
  :class:`CompositionalMetric`; ``__hash__`` stays identity-based.
* ``update`` runs through the engine (``metrics_tpu_torch/engine``): one
  update program per (class, configuration, input shapes), shared by every
  instance, replayed as a CUDA graph on the card and run eagerly on the CPU;
  the value checks skip inside it. List states, ``jit_update=False``,
  ``dist_sync_on_step=True`` and metrics whose program failed run the
  eager update, value checks included.
* ``on_bad_input`` screens NaN and ±Inf inputs (``resilience/health.py``).
* Observability (``obs/``): ``forward``, ``update``, ``compute`` and
  ``sync`` each run in a span while tracing or the event bus is on (one
  bool read each when both are off); :meth:`sync_report` counts the syncs,
  and :meth:`obs_snapshot` gathers the three reports.
* Sharded states (``sharding/``): ``add_state(sharding=)`` annotates a
  state with the mesh axes it is split over; :meth:`shard_states` (or
  ``drive(mesh=, in_specs=)``) lays it out over a ``DeviceMesh``, one
  process per device, each keeping its local shard (the layout is recorded
  in ``_shard_layout``). ``update`` then counts only this process's part
  (the metrics with ``_sharded_update`` window their kernels; others run
  on the gathered state and keep their slice), and ``compute`` sees the
  global state: reduced over the mesh axes the states are not split over,
  then gathered. ``axis_name`` and :meth:`sync_state`'s ``axis_name``
  reduce state dicts over named mesh axes (``parallel/comm.py``).
"""
import copy
import enum
import functools
import inspect
import warnings
from contextlib import contextmanager
from typing import Any, Callable, Dict, FrozenSet, Generator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from metrics_tpu_torch.engine import cache as _engine
from metrics_tpu_torch.obs import bus as _obs_bus
from metrics_tpu_torch.obs import trace as _obs_trace
from metrics_tpu_torch.obs.warn import instance_token, warn_once
from metrics_tpu_torch.parallel import comm, quantize
from metrics_tpu_torch.resilience import SYNC_ERROR_POLICIES
from metrics_tpu_torch.resilience import health as _health
from metrics_tpu_torch.resilience import new_sync_stats
from metrics_tpu_torch.sharding import spec as _shard_spec
from metrics_tpu_torch.utils import enums as _enums
from metrics_tpu_torch.utils.data import _squeeze_if_scalar, dim_zero_cat
from metrics_tpu_torch.utils.exceptions import MetricsUserError, NumericalHealthError, SyncError
from metrics_tpu_torch.utils.prints import rank_zero_warn

_MERGEABLE_FX = ("sum", "max", "min", "cat")


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The device a metric lives on: the card unless the caller names another."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "metrics_tpu_torch runs on the GPU by default and CUDA is not available;"
            " pass device='cpu' to run the plain PyTorch versions on the CPU."
        )
    return dev


#: the wire codecs of ``add_state(sync_precision=)``
SYNC_PRECISIONS = quantize.CODECS


def _torch_dtype(dtype: Any) -> torch.dtype:
    """A torch dtype from a torch, numpy or string dtype; TypeError for
    anything else."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def _normalize_placeholder(name: str, placeholder: Any) -> Tuple[Tuple[int, ...], torch.dtype]:
    """An ``add_state(placeholder=)`` declaration as the ``(shape, dtype)``
    of a zero-length tensor: a dtype means 1-d samples (``(0,)``); a tensor,
    array or spec with ``shape`` and ``dtype`` gives its row shape
    (``(0, *shape[1:])``: the leading axis is the sample axis)."""
    is_dtype = isinstance(placeholder, (torch.dtype, np.dtype, type, str))
    shape = None if is_dtype else getattr(placeholder, "shape", None)
    dtype = None if is_dtype else getattr(placeholder, "dtype", None)
    try:
        if shape is not None and dtype is not None:
            return (0,) + tuple(shape)[1:], _torch_dtype(dtype)
        return (0,), _torch_dtype(placeholder)
    except TypeError as err:
        raise ValueError(
            f"`placeholder` for state {name!r} must be a dtype or a shaped spec/array, got {placeholder!r}"
        ) from err


def _encode_dynamic(value: Any) -> Any:
    """JSON-safe form of an attribute learned during update (enums by name and value)."""
    if isinstance(value, enum.Enum):
        return {"$enum": type(value).__name__, "value": value.value}
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    raise TypeError(f"Dynamic state attr of type {type(value)} cannot be saved")


def _decode_dynamic(value: Any) -> Any:
    if isinstance(value, dict) and "$enum" in value:
        return getattr(_enums, value["$enum"])(value["value"])
    return value


class _ProcessLocal:
    """A process-local handle (a ``torch.distributed`` process group) in a
    metric's pickled state: a deep copy shares it, a pickle drops it."""

    def __init__(self, handle: Any) -> None:
        self.handle = handle

    def __deepcopy__(self, memo: Dict[int, Any]) -> "_ProcessLocal":
        return self

    def __reduce__(self) -> Tuple[Any, Tuple[Any, ...]]:
        return (_ProcessLocal, (None,))


class Metric(nn.Module):
    """Base class for all metrics.

    Subclasses register states with :meth:`add_state` and implement
    ``update(self, ...)`` and ``compute(self)``.

    Args:
        compute_on_step: return the batch value from ``forward``.
        dist_sync_on_step: sync the batch value of ``forward`` across
            processes too (a collective per state on every batch).
        process_group: what to sync over: a
            :class:`~metrics_tpu_torch.parallel.ProcessGroup` (the members
            exchange through the store, with a deadline, retry and partial
            results), or a ``torch.distributed.ProcessGroup``; the default
            group when None.
        dist_sync_fn: ``fn(tensor, group) -> List[tensor]``, one call per
            state in sorted state-name order, in place of the default
            ``all_gather``.
        axis_name: the mesh axis (or axes, outer first) that
            :meth:`sync_state` reduces over when it is given none; the mesh
            is the ``comm.axis_env`` one.
        on_sync_error: ``"raise"`` propagates a failed sync as a
            :class:`SyncError`; ``"local"`` warns and computes on the
            rank-local state; ``"partial"`` reduces, on a store
            ``ProcessGroup``, over the ranks that delivered within its
            deadline (elsewhere it degrades as ``"local"`` does).
        on_bad_input: what a NaN or ±Inf in the update inputs does:
            ``"propagate"`` (no screening), ``"raise"`` (the update is
            quarantined and :class:`NumericalHealthError` raised),
            ``"skip"`` (the update is quarantined and counted) or
            ``"mask"`` (the bad rows are dropped exactly). Counts in
            :meth:`health_report`.
        jit_update: run ``update`` through the engine's shared programs
            (CUDA graphs on the card); False keeps the eager update and its
            value checks.
        jit_bucket: ``"pow2"`` pads the batch axis to powers of two, with an
            exact correction, for the row-additive metrics; ``None`` keeps
            exact shapes.
        device: where the states live and the kernels run; ``None`` is the
            GPU, and raises when CUDA is not available.
    """

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = None
    #: Attributes learned during ``update`` that a checkpoint must carry.
    _dynamic_state_attrs: Tuple[str, ...] = ()
    #: Sum/mean/max/min states whose ``update`` may give them another shape
    #: than the registered default: the sync exchanges their shapes first,
    #: as for cat states, since a rank that never updated keeps the default.
    _shape_polymorphic_states: FrozenSet[str] = frozenset()
    #: ``compute`` needs concrete values, so a fused collection program
    #: leaves it out.
    _compute_is_host_side: bool = False
    #: Opt-in to ``jit_bucket`` padding and the compiled ``"mask"``: every
    #: batch row adds independently to every ``"sum"`` state, and axis 0 of
    #: each tensor input of rank >= 1 is the batch axis
    #: (``engine/bucketing.py``).
    _batch_additive: bool = False
    #: ``update`` windows its work to a placed state's local shard (reads
    #: :meth:`_state_window` / :meth:`_local_part`); without it a placed
    #: metric's update runs on the gathered global state and keeps its slice.
    _sharded_update: bool = False

    def __init__(
        self,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        axis_name: Optional[Union[str, Sequence[str]]] = None,
        on_sync_error: str = "raise",
        on_bad_input: str = "propagate",
        jit_update: bool = True,
        jit_bucket: Optional[str] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        super().__init__()
        self._device = resolve_device(device)
        self._warn_token = instance_token()
        self.compute_on_step = compute_on_step
        self.dist_sync_on_step = dist_sync_on_step
        if on_sync_error not in SYNC_ERROR_POLICIES:
            raise ValueError(f"`on_sync_error` must be one of {SYNC_ERROR_POLICIES}, got {on_sync_error!r}")
        self.on_sync_error = on_sync_error
        self._sync_stats = new_sync_stats()
        if on_bad_input not in _health.HEALTH_POLICIES:
            raise ValueError(f"`on_bad_input` must be one of {_health.HEALTH_POLICIES}, got {on_bad_input!r}")
        self.on_bad_input = on_bad_input
        # what counts as bad: "nonfinite" (NaN and ±Inf) or "nan" (the
        # aggregators' nan_strategy, where ±Inf is data); part of the program
        self.health_screen = "nonfinite"
        self._health_stats = _health.new_health_stats()
        self._health_warn_on_bad = False
        if jit_bucket not in (None, "pow2"):
            raise ValueError(f"`jit_bucket` must be None or 'pow2', got {jit_bucket!r}")
        self.jit_bucket = jit_bucket
        self._enable_jit = jit_update
        self._jit_failed = False
        self._engine_probed = False
        self._compile_stats = _engine.new_stats()
        if process_group is not None and dist_sync_fn is None:
            from metrics_tpu_torch.parallel.groups import ProcessGroup

            # fail here, not in the first distributed compute(): the default gather takes these two
            if not isinstance(process_group, (ProcessGroup, dist.ProcessGroup)):
                raise ValueError(
                    f"Unsupported `process_group` {process_group!r}: pass a metrics_tpu_torch.parallel.ProcessGroup"
                    " (a store-backed subgroup), a torch.distributed.ProcessGroup that this process is a member of,"
                    " or a `dist_sync_fn` that understands your group object."
                )
        self.process_group = process_group
        self.dist_sync_fn = dist_sync_fn
        self.axis_name = axis_name
        # per-state sharding annotations (add_state(sharding=)): configuration
        # that names mesh axes; a mesh binds at shard_states / drive(mesh=)
        self._state_shardings: Dict[str, Any] = {}
        # the mesh the states are laid out over, and each placed state's layout
        self._shard_mesh: Optional[Any] = None
        self._shard_layout: Dict[str, Any] = {}
        # set by a mesh drive whose sync made the states global across
        # processes: host update/forward/sync raise until reset()
        self._drive_synced = False
        self._update_signature = inspect.signature(self.update)
        self.update: Callable = self._wrap_update(self.update)  # type: ignore[method-assign]
        self.compute: Callable = self._wrap_compute(self.compute)  # type: ignore[method-assign]
        self._computed: Any = None
        self._forward_cache: Any = None
        self._update_count = 0
        self._defaults: Dict[str, Union[torch.Tensor, List]] = {}
        self._persistent: Dict[str, bool] = {}
        self._reductions: Dict[str, Union[str, Callable, None]] = {}
        # list states' declared empty-gather (shape, dtype): add_state(placeholder=)
        self._list_placeholders: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
        # each state's wire codec tag (add_state(sync_precision=))
        self._sync_precisions: Dict[str, str] = {}
        self._to_sync = True
        self._should_unsync = True
        self._is_synced = False
        self._cache: Optional[Dict[str, Any]] = None
        # overrides the "is a distributed world present" check (in-process tests of a dist_sync_fn)
        self._distributed_available_fn: Optional[Callable] = None
        if on_bad_input != "propagate":
            # the counters are a "sum" state, registered only under a policy
            # so the default keeps the reference's state set
            _health.attach_state(self)

    @property
    def device(self) -> torch.device:
        return self._device

    # ------------------------------------------------------------------
    # state registration
    # ------------------------------------------------------------------
    def add_state(
        self,
        name: str,
        default: Union[torch.Tensor, List, float, int, np.ndarray],
        dist_reduce_fx: Union[str, Callable, None] = None,
        persistent: bool = False,
        placeholder: Optional[Any] = None,
        sync_precision: str = "exact",
        sharding: Optional[Any] = None,
    ) -> None:
        """Register a state: a tensor (any array-like is converted and put on
        the metric's device) or an empty list; ``dist_reduce_fx`` one of
        ``"sum"/"mean"/"max"/"min"/"cat"``, ``None`` (a sync stacks the
        ranks' states) or a callable that takes that stack.

        ``placeholder`` (list states only) declares the dtype, and for
        row-shaped samples the row shape, of the tensors the list will hold:
        a dtype (``torch.int64``, ``np.int64``) or a tensor or array whose
        trailing shape is the row's. While the list is empty it concatenates
        to ``zeros((0, *row), dtype)``, in a sync as in :meth:`cat_state`, so
        a sync in which every rank is empty gives that tensor; a rank that is
        empty beside ranks that hold data takes their dtype.

        ``sharding`` (array states only) annotates the state with the mesh
        axes its dimensions are split over: a
        :class:`~metrics_tpu_torch.sharding.PartitionSpec`, or a bare axis
        name for the leading axis. It is honoured by :meth:`shard_states`
        and ``drive(mesh=, in_specs=)``, carried by :meth:`state_spec` and
        checked by :meth:`bind_state`.

        ``sync_precision`` tags the state's wire codec in the host sync
        (``"exact"``, the default, ``"bf16"`` or ``"int8"``; see
        ``parallel/quantize.py``). A quantized tag declares a tolerance: the
        state's floats may round-trip the sync with a bounded error (bf16:
        one bf16 ulp relative; int8: absmax/254 of each 256-element block)
        for 2-4x fewer bytes, on the store exchange of a
        :class:`~metrics_tpu_torch.parallel.ProcessGroup` and on a
        ``torch.distributed`` ``all_gather`` alike. Integer and bool states
        always travel exact."""
        if sync_precision not in SYNC_PRECISIONS:
            raise ValueError(
                f"`sync_precision` for state {name!r} must be one of {SYNC_PRECISIONS}, got {sync_precision!r}"
            )
        if sharding is not None:
            self._state_shardings[name] = _shard_spec.normalize_state_sharding(name, sharding, default)
        if placeholder is not None:
            if not isinstance(default, list):
                raise ValueError(
                    f"`placeholder` declares the empty-gather contribution of a LIST state; {name!r} has an array default."
                )
            self._list_placeholders[name] = _normalize_placeholder(name, placeholder)
        if isinstance(default, list):
            if default:
                raise ValueError("state defaults that are lists must be empty")
        elif isinstance(default, (torch.Tensor, np.ndarray, float, int)):
            default = torch.as_tensor(default, device=self._device)
        else:
            raise ValueError("state variable must be a tensor or an empty list")
        if dist_reduce_fx not in (None, "sum", "mean", "max", "min", "cat") and not callable(dist_reduce_fx):
            raise ValueError("`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', 'min', 'max', None]")
        if name in ("update", "compute", "forward", "reset"):
            raise ValueError(f"The name {name!r} clashes with a Metric method")
        self._defaults[name] = default
        self._persistent[name] = persistent
        self._reductions[name] = dist_reduce_fx
        self._sync_precisions[name] = sync_precision
        if isinstance(default, list):
            setattr(self, name, [])
        else:
            # saved by _save_to_state_dict below, under this metric's rules
            self.register_buffer(name, default.clone(), persistent=False)

    def cat_state(self, name: str) -> torch.Tensor:
        """List state ``name`` concatenated along dim 0 (a tensor after a
        sync, as it is). An empty list gives its declared placeholder; with
        none declared it raises, as :func:`dim_zero_cat` does."""
        value = getattr(self, name)
        if isinstance(value, list) and not value and name in self._list_placeholders:
            return self._empty_leaf(name)
        return dim_zero_cat(value)

    def _empty_leaf(self, name: str) -> torch.Tensor:
        """An empty list state's tensor: its declared placeholder, else a
        zero-length float32 vector."""
        shape, dtype = self._list_placeholders.get(name, ((0,), torch.float32))
        return torch.zeros(shape, dtype=dtype, device=self._device)

    def _default_value(self, name: str) -> Union[torch.Tensor, List]:
        d = self._defaults[name]
        return [] if isinstance(d, list) else d.clone()

    def _snapshot_state(self) -> Dict[str, Any]:
        return {n: (list(v) if isinstance(v, list) else v) for n, v in ((n, getattr(self, n)) for n in self._defaults)}

    def _restore_state(self, state: Dict[str, Any]) -> None:
        for n, v in state.items():
            setattr(self, n, v)

    @property
    def _states_mergeable(self) -> bool:
        return all(isinstance(self._defaults[n], list) or self._reductions[n] in _MERGEABLE_FX for n in self._defaults)

    # ------------------------------------------------------------------
    # pure (explicitly state-passing) API
    # ------------------------------------------------------------------
    def init_state(self) -> Dict[str, Any]:
        """Fresh state dict from the registered defaults."""
        return {n: self._default_value(n) for n in self._defaults}

    def _with_state(self, state: Dict[str, Any], fn: Callable, *args: Any, **kwargs: Any) -> Any:
        saved = self._snapshot_state()
        self._restore_state({n: (list(v) if isinstance(v, list) else v) for n, v in state.items()})
        try:
            return fn(*args, **kwargs)
        finally:
            self._restore_state(saved)

    def update_state(self, state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Pure update: ``state, batch -> new state``; ``state`` is left as it was."""

        def _run() -> Dict[str, Any]:
            with torch.no_grad():
                self._update_impl(*args, **kwargs)
            return self._snapshot_state()

        return self._with_state(state, _run)

    def compute_state(self, state: Dict[str, Any]) -> Any:
        """Pure compute: ``state -> value``."""
        with torch.no_grad():
            return self._with_state(state, self._compute_impl)

    def sync_state(
        self,
        state: Dict[str, Any],
        axis_name: Optional[Union[str, Sequence[str]]] = None,
        hierarchical: bool = False,
        *,
        process_group: Optional[Any] = None,
    ) -> Dict[str, Any]:
        """Pure sync; ``state`` is left as it was.

        With ``axis_name`` (or the constructor's), the in-program sync over
        those axes of the ``comm.axis_env`` mesh: one collective per state,
        sum/mean/max/min as all-reduces, ``cat`` and ``None`` as gathers (a
        list state comes back as a one-element list);
        ``hierarchical=True`` with two or more axes (outer first) stages
        them inner axis first (``comm.reduce_in_trace``).

        Without one, the host sync: ``state`` gathered from every rank of
        ``process_group`` (this metric's group when None) and reduced as
        ``compute`` would. Under ``on_sync_error="local"`` a failed host
        sync returns the local state, with a warning."""
        axis = axis_name if axis_name is not None else self.axis_name
        if axis is not None and process_group is None:
            return comm.sync_state_in_trace(
                state, self._reductions, axis, placeholders=self._list_placeholders, hierarchical=hierarchical
            )
        group = process_group if process_group is not None else self.process_group
        gathered = self._gather_with_policy(self._sync_leaves(state), group, self.dist_sync_fn)
        if gathered is None:
            return dict(state)
        return self._reduce_gathered(gathered)

    def merge_states(self, state_a: Dict[str, Any], state_b: Dict[str, Any]) -> Dict[str, Any]:
        """Merge two independently accumulated states with each state's reduction."""
        out: Dict[str, Any] = {}
        for name in self._defaults:
            fx = self._reductions[name]
            a, b = state_a[name], state_b[name]
            if isinstance(self._defaults[name], list):
                out[name] = list(a) + list(b)
            elif fx == "sum":
                out[name] = a + b
            elif fx == "max":
                out[name] = torch.maximum(a, b)
            elif fx == "min":
                out[name] = torch.minimum(a, b)
            elif fx == "cat":
                out[name] = torch.cat([torch.atleast_1d(a), torch.atleast_1d(b)], dim=0)
            else:
                raise MetricsUserError(f"State {name!r} with dist_reduce_fx={fx!r} cannot be merged pairwise")
        return out

    def state_spec(self) -> Dict[str, Any]:
        """``name -> StateSpec(shape, dtype, sharding)`` for every tensor
        state (list states map to None): the global shape, placed or not,
        and the registered ``add_state(sharding=)`` annotation (None for a
        state that is not split)."""
        return {
            name: None
            if isinstance(default, list)
            else _shard_spec.StateSpec(
                _shard_spec.registered_shape(self, name), default.dtype, self._state_shardings.get(name)
            )
            for name, default in self._defaults.items()
        }

    def shard_states(self, mesh: Any) -> "Metric":
        """Lay the registered-sharded states out over ``mesh`` (a
        ``torch.distributed.device_mesh.DeviceMesh`` with named dims, one
        process per device): each process keeps its shard of the states and
        of their defaults, so :meth:`reset` stays placed. States without an
        annotation are untouched. Afterwards ``update`` follows the mesh's
        data-parallel contract (the processes of one split axis group feed
        the same batch) and ``compute`` sees the global state. Clones and
        pickles keep the annotations, not the placement."""
        return _shard_spec.place_states(self, mesh)

    def sharded_state(self, name: str) -> Any:
        """A placed state as a ``torch.distributed.tensor.DTensor`` over the
        mesh (a view of the local shard, no copy); a state that is not
        placed as it is."""
        layout = self._shard_layout.get(name)
        value = getattr(self, name)
        if layout is None:
            return value
        return _shard_spec.dtensor_view(value, layout, self._shard_mesh)

    def _state_window(self, name: str, dim: int = 0) -> Optional[Tuple[int, int]]:
        """``(offset, length)`` of this process's shard along ``dim`` when a
        placed state is split along that dimension alone, else None."""
        layout = self._shard_layout.get(name)
        if layout is None or [d for d, _ in layout.splits] != [dim]:
            return None
        return layout.offsets[dim], layout.local_shape[dim]

    def _local_part(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This process's shard of a global value of state ``name`` (the
        value itself when the state is not placed)."""
        layout = self._shard_layout.get(name)
        if layout is None:
            return full
        out = full
        for dim, _ in layout.splits:
            out = out.narrow(dim, layout.offsets[dim], layout.local_shape[dim])
        return out

    def _update_gathered(self, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> None:
        """The update of a placed metric without ``_sharded_update``: on the
        global states (gathered over their split axes), eagerly, keeping
        this process's slice."""
        saved = self._snapshot_state()
        mesh = self._shard_mesh
        self._restore_state(
            {
                n: _shard_spec.gather_state(v, self._shard_layout[n], mesh) if n in self._shard_layout else v
                for n, v in saved.items()
            }
        )
        try:
            self._eager_update(_health.health_enabled(self), args, kwargs)
        except BaseException:
            self._restore_state(saved)
            raise
        new = self._snapshot_state()
        self._restore_state({n: self._local_part(n, v).clone() if n in self._shard_layout else v for n, v in new.items()})

    def bind_state(self, state: Dict[str, Any], update_count: Optional[int] = None) -> "Metric":
        """Bind a state tree (tensors or numpy arrays) onto this instance,
        the inverse of ``_snapshot_state`` for state held outside the metric.
        Each state is checked against its registration (the names, list
        against tensor, the shape unless the state is in
        ``_shape_polymorphic_states``, float against integer) and cast to
        the registered dtype on this metric's device; nothing is bound if a
        check fails. ``update_count``, where given, becomes the number of
        updates the lifecycle sees. A state registered with ``sharding=``
        may be a ``DTensor`` laid out as registered (or not split); another
        layout raises, naming ``Class.state``. A placed metric takes a
        global value (and keeps its shard) or its shard."""
        cls = type(self).__name__
        unknown = sorted(set(state) - set(self._defaults))
        missing = sorted(set(self._defaults) - set(state))
        if unknown or missing:
            raise MetricsUserError(
                f"bind_state on {cls}: state tree does not match the registered states"
                f" (missing {missing}, unknown {unknown})."
            )
        bound: Dict[str, Any] = {}
        for name, value in state.items():
            default = self._defaults[name]
            if isinstance(default, list) != isinstance(value, list):
                raise MetricsUserError(
                    f"bind_state on {cls}: state {name!r} kind (list vs array) does not match its registration."
                )
            if isinstance(default, list):
                bound[name] = [torch.as_tensor(v, device=self._device) for v in value]
                continue
            registered = self._state_shardings.get(name)
            conflict = None if registered is None else _shard_spec.sharding_conflict(registered, value)
            if conflict is not None:
                raise MetricsUserError(
                    f"bind_state on {cls}: state {cls}.{name} is {conflict} — rebind an unsharded/replicated tree"
                    " (placement will re-lay it out) or one already partitioned per the registered spec."
                )
            t = _shard_spec.local_value(self, name, value)
            if t.shape != default.shape and name not in self._shape_polymorphic_states:
                raise MetricsUserError(
                    f"bind_state on {cls}: state {name!r} has registered shape {tuple(default.shape)} but the"
                    f" tree holds {tuple(t.shape)} — state from a different configuration?"
                )
            if t.is_floating_point() != default.is_floating_point():
                raise MetricsUserError(
                    f"bind_state on {cls}: state {name!r} is registered as {default.dtype} but the tree holds"
                    f" {t.dtype} (float/integer kind mismatch)."
                )
            bound[name] = t.to(default.dtype)
        self._restore_state(bound)
        if update_count is not None:
            self._update_count = int(update_count)
        self._computed = None
        self._is_synced = False
        self._cache = None
        counts = bound.get(_health.HEALTH_STATE)
        _health.reset_seen_mirrors(self, None if counts is None else counts.cpu().numpy())
        return self

    # ------------------------------------------------------------------
    # lifecycle: forward / update / compute / reset
    # ------------------------------------------------------------------
    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Accumulate the batch into the state and (optionally) return the batch value."""
        if not _obs_trace.active():
            return self._forward_impl(*args, **kwargs)
        # a fenced span waits for the batch value, so it covers the device work
        with _obs_trace.span("forward", type(self).__name__, payload=lambda: self._forward_cache):
            return self._forward_impl(*args, **kwargs)

    def _forward_impl(self, *args: Any, **kwargs: Any) -> Any:
        if self._is_synced:
            raise MetricsUserError(
                "The Metric shouldn't be synced when performing ``forward``. HINT: Did you forget to call ``unsync``?"
            )
        if not self.compute_on_step:
            self.update(*args, **kwargs)
            return None
        use_dance = self.full_state_update if self.full_state_update is not None else not self._states_mergeable
        if use_dance:
            value = self._forward_full_state_update(*args, **kwargs)
        else:
            value = self._forward_reduce_state_update(*args, **kwargs)
        self._forward_cache = value
        return value

    def _forward_full_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """Update the accumulated state, then compute the batch value on a fresh one."""
        self.update(*args, **kwargs)
        cache = self._snapshot_state()
        update_count = self._update_count
        computed = self._computed
        try:
            self._to_sync = self.dist_sync_on_step
            for name in self._defaults:
                setattr(self, name, self._default_value(name))
            self._update_count = 1
            self._computed = None
            self._should_unsync = False  # the accumulated state is restored below
            self.update(*args, **kwargs)
            batch_val = self.compute()
        finally:
            self._restore_state(cache)
            self._update_count = update_count
            self._computed = computed
            self._should_unsync = True
            self._to_sync = True
            self._is_synced = False
            self._cache = None
        return batch_val

    def _forward_reduce_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """Batch delta on fresh state, merged into the accumulated state."""
        global_state = self._snapshot_state()
        update_count = self._update_count
        try:
            for name in self._defaults:
                setattr(self, name, self._default_value(name))
            self.update(*args, **kwargs)
            # the local batch state, taken before a dist_sync_on_step compute
            # syncs it: merging the synced state would count every rank's batch
            batch_state = self._snapshot_state()
            self._to_sync = self.dist_sync_on_step
            batch_val = self.compute()
            merged = self.merge_states(global_state, batch_state)
        except BaseException:
            # keep the prior accumulation when the batch update or compute raised
            self._restore_state(global_state)
            self._update_count = update_count
            raise
        finally:
            self._to_sync = True
            self._is_synced = False
            self._cache = None
        self._restore_state(merged)
        self._update_count = update_count + 1
        self._computed = None
        return batch_val

    def _wrap_update(self, update: Callable) -> Callable:
        @functools.wraps(update)
        def wrapped_func(*args: Any, **kwargs: Any) -> None:
            if self._drive_synced:
                raise MetricsUserError(
                    f"{type(self).__name__} holds the globally-synced state of a mesh-mode engine.drive: a"
                    " host-side update would be dropped from (or double-counted in) the cross-rank total."
                    " reset() first, or accumulate further epochs through drive(mesh=...)."
                )
            self._computed = None
            self._update_count += 1
            with torch.no_grad():
                if not _obs_trace.active():
                    self._update_impl(*args, **kwargs)
                    return
                with _obs_trace.span("update", type(self).__name__, payload=self._snapshot_state):
                    self._update_impl(*args, **kwargs)

        self._inner_update = update
        return wrapped_func

    def _update_impl(self, *args: Any, **kwargs: Any) -> None:
        """One update: through the engine's shared program where it can run
        as one, else the eager update (with the value checks)."""
        screened = _health.health_enabled(self)
        if screened:
            self._health_stats["batches_screened"] += 1
        if self._shard_layout and not self._sharded_update:
            self._update_gathered(args, kwargs)
            return
        if (
            not self._enable_jit
            or self._jit_failed
            or self.dist_sync_on_step
            or self._has_list_state()
            or (screened and _health.forces_eager(self))
        ):
            self._eager_update(screened, args, kwargs)
            return
        saved = self._snapshot_state()
        try:
            new_state = _engine.update_transition(self, saved, args, kwargs)
        except _engine.FALLBACK_ERRORS:
            self._jit_failed = True
            self._restore_state(saved)
            self._eager_update(screened, args, kwargs)
            return
        except BaseException:
            self._restore_state(saved)
            raise
        self._restore_state(new_state)
        if screened and self.on_bad_input == "raise":
            _health.raise_on_quarantine(self)

    def _eager_update(self, screened: bool, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> None:
        if screened:
            _health.eager_update(self, args, kwargs)
        else:
            self._inner_update(*args, **kwargs)

    def _has_list_state(self) -> bool:
        return any(isinstance(getattr(self, n), list) for n in self._defaults)

    def _health_prescreen(self, args: Any, kwargs: Any) -> Any:
        """Hook: normalize the update inputs before the non-finite screening
        (runs only under a health policy). Identity here; the aggregators
        flatten rank >= 2 values so ``"mask"`` drops elements."""
        return args, kwargs

    def compile_stats(self) -> Dict[str, Any]:
        """This instance's engine telemetry: ``compiles`` (programs its
        dispatches created: CUDA graph captures on the card), ``cache_hits``
        (updates served by an existing program, perhaps captured by another
        instance), ``retraces`` (programs beyond a variant's first) and
        ``bucketed_calls``; with ``jit_enabled``, ``jit_failed`` (the metric
        fell back to its eager update) and ``jit_bucket``. Process-wide:
        ``metrics_tpu_torch.engine.cache_summary``."""
        out: Dict[str, Any] = dict(self._compile_stats)
        out["jit_enabled"] = self._enable_jit
        out["jit_failed"] = self._jit_failed
        out["jit_bucket"] = self.jit_bucket
        children = self._children()
        if children:
            out["children"] = {k: c.compile_stats() for k, c in children.items()}
        return out

    def health_report(self) -> Dict[str, Any]:
        """Numerical-health telemetry: the device counters ``nan_count``,
        ``inf_count``, ``rows_masked``, ``updates_quarantined`` and
        ``overflow_events`` (a ``"sum"`` state: they reset, merge, sync and
        checkpoint with the metric; 0 under ``"propagate"``), and the host
        counters ``batches_screened`` and ``last_compute_nonfinite``. A
        wrapper's inner metrics report under ``children``."""
        out = _health.metric_report(self)
        children = self._children()
        if children:
            out["children"] = {k: c.health_report() for k, c in children.items()}
        return out

    def sync_report(self) -> Dict[str, Any]:
        """Host-level sync telemetry, the JAX package's keys
        (``resilience.new_sync_stats``): ``syncs``, ``attempts`` and
        ``retries``, ``kv_timeouts``, ``integrity_failures``,
        ``barrier_timeouts``, ``backoff_s``, ``bytes_sent``/
        ``bytes_received``, ``degraded_local``/``degraded_partial``, the
        wire codec counters, and of the last sync ``missing_ranks`` and
        ``last_sync_outcome`` (``"complete"``, ``"partial"``, ``"local"``,
        ``"failed"``, None before the first sync). The counters live with
        the instance: ``pickle``, ``clone`` and ``deepcopy`` keep them. A
        wrapper's inner metrics report under ``children``."""
        out: Dict[str, Any] = dict(self._sync_stats)
        out["missing_ranks"] = list(self._sync_stats["missing_ranks"])
        out["codec_counts"] = dict(self._sync_stats["codec_counts"])
        out["on_sync_error"] = self.on_sync_error
        out["process_group"] = getattr(self.process_group, "name", None)
        children = self._children()
        if children:
            out["children"] = {k: c.sync_report() for k, c in children.items()}
        return out

    def _children(self) -> Dict[str, "Metric"]:
        """Inner metrics whose reports this metric's :meth:`compile_stats`,
        :meth:`sync_report` and :meth:`health_report` nest under
        ``"children"``: the wrappers override it. Empty for a plain metric."""
        return {}

    def obs_snapshot(self) -> Dict[str, Any]:
        """Every telemetry surface of this instance in one dict (the metric
        face of :func:`metrics_tpu_torch.obs.snapshot`): ``class``, and the
        ``compile``, ``sync`` and ``health`` sections, each the dict
        :meth:`compile_stats`, :meth:`sync_report` and :meth:`health_report`
        return. Wrapper children ride inside each section, once."""
        return {
            "class": type(self).__name__,
            "compile": self.compile_stats(),
            "sync": self.sync_report(),
            "health": self.health_report(),
        }

    def compute_async(self) -> Any:
        """:meth:`compute` with the device-to-host copy started at once and
        coalesced: the returned :class:`~metrics_tpu_torch.engine.AsyncResult`
        resolves with one copy of the whole result."""
        from metrics_tpu_torch.engine.driver import async_compute

        return async_compute(self)

    def _wrap_compute(self, compute: Callable) -> Callable:
        def compute_body(*args: Any, **kwargs: Any) -> Any:
            if self._update_count == 0:
                warn_once(
                    f"The ``compute`` method of metric {self.__class__.__name__}"
                    " was called before the ``update`` method which may lead to errors,"
                    " as metric states have not yet been updated.",
                    UserWarning,
                    key=("compute_before_update", self._warn_token),
                )
            if self._computed is not None:
                return self._computed
            if self._shard_layout:
                # a placed state's global view: reduced over the data axes
                # (unless a mesh drive's sync already did), then gathered
                context = _shard_spec.global_view(self, reduce_data=self._to_sync and not self._drive_synced)
            else:
                context = self.sync_context(
                    dist_sync_fn=self.dist_sync_fn,
                    process_group=self.process_group,
                    should_sync=self._to_sync,
                    should_unsync=self._should_unsync,
                    distributed_available=self._distributed_available_fn,
                )
            with torch.no_grad(), context:
                self._computed = _squeeze_if_scalar(compute(*args, **kwargs))
            if _health.health_enabled(self):
                _health.check_compute_result(self, self._computed)
            return self._computed

        @functools.wraps(compute)
        def wrapped_func(*args: Any, **kwargs: Any) -> Any:
            if not _obs_trace.active():
                return compute_body(*args, **kwargs)
            with _obs_trace.span("compute", type(self).__name__, payload=lambda: self._computed):
                return compute_body(*args, **kwargs)

        self._compute_impl = compute
        return wrapped_func

    def reset(self) -> None:
        """Reset states to their defaults."""
        self._update_count = 0
        self._forward_cache = None
        self._computed = None
        for name in self._defaults:
            setattr(self, name, self._default_value(name))
        self._cache = None
        self._is_synced = False
        # a mesh drive leaves _to_sync False and _drive_synced True; a reset
        # state is local again (placed defaults stay placed)
        self._to_sync = True
        self._drive_synced = False
        # the "raise" mirrors follow the counters back to zero
        _health.reset_seen_mirrors(self)

    # ------------------------------------------------------------------
    # cross-process sync
    # ------------------------------------------------------------------
    def _sync_leaves(self, state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One tensor per state, in sorted state-name order: a list state is
        concatenated, and an empty one is its declared placeholder, else a
        zero-length float32 tensor (the gather gives it the dtype of the
        ranks that hold data)."""
        leaves = {}
        for name in sorted(self._reductions):
            v = state[name]
            if isinstance(v, list):
                v = dim_zero_cat(v) if v else self._empty_leaf(name)
            leaves[name] = v
        return leaves

    def _gather_with_policy(
        self, leaves: Dict[str, torch.Tensor], group: Optional[Any], dist_sync_fn: Optional[Callable]
    ) -> Optional[Dict[str, List[torch.Tensor]]]:
        """Every responding rank's tensor for each leaf, or None when the
        sync failed and the policy keeps the rank-local state.

        The one place ``on_sync_error`` applies, shared by :meth:`_sync_dist`,
        :meth:`sync_state` and mAP's packed leaves. The gather is
        ``parallel.groups.gather_state_trees``: a
        :class:`~metrics_tpu_torch.parallel.ProcessGroup` exchanges the whole
        tree through the store, where ``"partial"`` reduces over the ranks
        that delivered (``missing_ranks``, ``degraded_partial``, outcome
        ``"partial"``, a ``sync_degrade`` event and a warning); every other
        path gathers leaf by leaf and degrades the whole state (``"local"``,
        or a whole-state failure under ``"partial"``). Counts into
        :meth:`sync_report`."""
        from metrics_tpu_torch.parallel.groups import gather_state_trees

        policy = self.on_sync_error
        stats = self._sync_stats
        stats["syncs"] += 1
        stats["missing_ranks"] = []
        stats["last_sync_outcome"] = "failed"  # until the gather returns
        try:
            member_trees = gather_state_trees(
                leaves,
                group,
                dist_sync_fn,
                policy="partial" if policy == "partial" else "raise",
                report=stats,
                # fixed by registration, so the same on every rank: list
                # states, shape-polymorphic states and leaves that are not
                # registered states (a subclass's packing) stay ragged
                reductions={
                    n: fx
                    for n, fx in self._reductions.items()
                    if n not in self._shape_polymorphic_states and not isinstance(self._defaults[n], list)
                },
                sync_precisions={n: p for n, p in self._sync_precisions.items() if p != "exact"},
            )
        except SyncError as err:
            if policy == "raise":
                if _obs_bus.enabled():
                    _obs_bus.emit(
                        "sync_degrade", source=type(self).__name__, policy=policy, outcome="failed", error=str(err)
                    )
                raise
            stats["degraded_local"] += 1
            stats["last_sync_outcome"] = "local"
            if _obs_bus.enabled():
                _obs_bus.emit("sync_degrade", source=type(self).__name__, policy=policy, outcome="local", error=str(err))
            rank_zero_warn(
                f"Distributed sync of {self.__class__.__name__} failed; keeping the rank-local state"
                f" (on_sync_error={policy!r}). Original error: {err}",
                UserWarning,
            )
            return None
        missing = stats["missing_ranks"]
        stats["last_sync_outcome"] = "partial" if missing else "complete"
        if missing:
            stats["degraded_partial"] += 1
            if _obs_bus.enabled():
                _obs_bus.emit(
                    "sync_degrade", source=type(self).__name__, policy=policy, outcome="partial", missing_ranks=list(missing)
                )
            rank_zero_warn(
                f"Partial distributed sync of {self.__class__.__name__}: ranks {missing} did not deliver within"
                f" the group deadline; reducing over the {len(member_trees)} responding member(s)"
                " (on_sync_error='partial').",
                UserWarning,
            )
        return {name: [tree[name] for tree in member_trees] for name in leaves}

    def _reduce_gathered(self, gathered: Dict[str, List[torch.Tensor]]) -> Dict[str, Any]:
        """Each state's reduction over the ranks' tensors. A list state drops
        the ranks that held nothing; if none did, it is its declared
        placeholder, or an empty list when it has none."""
        out: Dict[str, Any] = {}
        for name, parts in gathered.items():
            if isinstance(self._defaults[name], list):
                held = [p for p in parts if p.numel()]
                if not held:
                    out[name] = comm.reduce_gathered(parts, self._reductions[name]) if name in self._list_placeholders else []
                    continue
                parts = held
            out[name] = comm.reduce_gathered(parts, self._reductions[name])
        return out

    def _sync_dist(self, dist_sync_fn: Optional[Callable] = None, process_group: Optional[Any] = None) -> None:
        """Replace every state with its reduction across the ranks of the group."""
        group = process_group if process_group is not None else self.process_group
        gathered = self._gather_with_policy(self._sync_leaves(self._snapshot_state()), group, dist_sync_fn)
        if gathered is not None:
            self._restore_state(self._reduce_gathered(gathered))

    def sync(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        distributed_available: Optional[Callable] = None,
    ) -> None:
        """Cache the local state and replace it with the cross-process reduction."""
        if self._is_synced and should_sync:
            raise MetricsUserError("The Metric has already been synced.")
        if self._drive_synced and should_sync:
            raise MetricsUserError(
                f"{type(self).__name__} holds the globally-synced state of a mesh-mode engine.drive: a host-side"
                " sync would re-reduce the identical global totals world_size-fold. Its compute() already skips"
                " the sync; reset() restores the ordinary contract."
            )
        if distributed_available is None:
            distributed_available = comm.distributed_available
        is_distributed = distributed_available() if callable(distributed_available) else bool(distributed_available)
        if not should_sync or not is_distributed:
            return
        self._cache = self._snapshot_state()
        if not _obs_trace.active():
            self._sync_dist(dist_sync_fn, process_group=process_group)
        else:
            with _obs_trace.span("sync", type(self).__name__, payload=self._snapshot_state):
                self._sync_dist(dist_sync_fn, process_group=process_group)
        self._is_synced = True

    def unsync(self, should_unsync: bool = True) -> None:
        """Restore the local state cached by :meth:`sync`."""
        if not should_unsync:
            return
        if not self._is_synced:
            raise MetricsUserError("The Metric has already been un-synced.")
        if self._cache is None:
            raise MetricsUserError("The internal cache should exist to unsync the Metric.")
        self._restore_state(self._cache)
        self._is_synced = False
        self._cache = None

    @contextmanager
    def sync_context(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        should_unsync: bool = True,
        distributed_available: Optional[Callable] = None,
    ) -> Generator[None, None, None]:
        """:meth:`sync` on enter, :meth:`unsync` on exit."""
        self.sync(
            dist_sync_fn=dist_sync_fn,
            process_group=process_group,
            should_sync=should_sync,
            distributed_available=distributed_available,
        )
        yield
        self.unsync(should_unsync=self._is_synced and should_unsync)

    def update(self, *_: Any, **__: Any) -> None:  # pragma: no cover - replaced in __init__
        """Override to update the metric state from a batch."""
        raise NotImplementedError

    def compute(self) -> Any:  # pragma: no cover - replaced in __init__
        """Override to compute the final value from the metric state."""
        raise NotImplementedError

    def _apply(self, fn: Callable, *args: Any, **kwargs: Any) -> "Metric":
        """``.to()``/``.cuda()``/``.cpu()`` move the defaults, the list states
        and the local state cached by a sync with the buffers, so ``reset``
        and ``unsync`` stay on the new device."""
        super()._apply(fn, *args, **kwargs)
        self._defaults = {n: (d if isinstance(d, list) else fn(d)) for n, d in self._defaults.items()}
        for name, d in self._defaults.items():
            if isinstance(d, list):
                v = getattr(self, name)  # a tensor while synced
                setattr(self, name, [fn(x) for x in v] if isinstance(v, list) else fn(v))
            else:
                self._device = d.device
        if self._cache is not None:
            self._cache = {n: ([fn(x) for x in c] if isinstance(c, list) else fn(c)) for n, c in self._cache.items()}
        return self

    # ------------------------------------------------------------------
    # device / dtype
    # ------------------------------------------------------------------
    def to_device(self, device: Union[str, torch.device]) -> "Metric":
        """Move the states, defaults and sync cache to ``device``."""
        self.to(device)
        self._device = torch.device(device)
        return self

    def astype(self, dtype: torch.dtype) -> "Metric":
        """Cast the current floating-point states to ``dtype``. The defaults
        keep their dtype, so ``reset`` brings back the registered one."""

        def _cast(x: torch.Tensor) -> torch.Tensor:
            return x.to(dtype) if x.is_floating_point() else x

        for name in self._defaults:
            v = getattr(self, name)
            setattr(self, name, [_cast(x) for x in v] if isinstance(v, list) else _cast(v))
        return self

    def half(self) -> "Metric":  # type: ignore[override]
        return self.astype(torch.float16)

    def float(self) -> "Metric":  # type: ignore[override]
        return self.astype(torch.float32)

    def double(self) -> "Metric":  # type: ignore[override]
        return self.astype(torch.float64)

    def bfloat16(self) -> "Metric":  # type: ignore[override]
        return self.astype(torch.bfloat16)

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def persistent(self, mode: bool = False) -> None:
        """Whether the states (and learned attributes) go into ``state_dict``."""
        for name in self._persistent:
            self._persistent[name] = mode

    def _save_to_state_dict(self, destination: Dict[str, Any], prefix: str, keep_vars: bool) -> None:
        for name in self._defaults:
            if not self._persistent[name]:
                continue
            v = getattr(self, name)
            if name in self._shard_layout:
                v = self.sharded_state(name)  # a DTensor: each process saves its shard
            destination[prefix + name] = list(v) if isinstance(v, list) else (v if keep_vars else v.detach())
        if any(self._persistent.values()):
            for attr in self._dynamic_state_attrs:
                destination[prefix + attr] = _encode_dynamic(getattr(self, attr))

    def _load_from_state_dict(
        self,
        state_dict: Dict[str, Any],
        prefix: str,
        local_metadata: Dict[str, Any],
        strict: bool,
        missing_keys: List[str],
        unexpected_keys: List[str],
        error_msgs: List[str],
    ) -> None:
        """Loads every state found in ``state_dict`` (onto this metric's
        device, in its registered dtype; a ``_shape_polymorphic_states``
        state in any shape); a persistent state that is absent is a missing
        key. A global value of a placed state (a JAX ``state_dict``, say)
        keeps this process's shard, and the metric then holds the global
        state (``sharding.spec.mark_global``)."""
        loaded_global = False
        for name, default in self._defaults.items():
            key = prefix + name
            if key not in state_dict:
                # a checkpoint from before a health policy keeps zero counters
                if self._persistent[name] and name != _health.HEALTH_STATE:
                    missing_keys.append(key)
                continue
            v = state_dict[key]
            if isinstance(default, list):
                setattr(self, name, [torch.as_tensor(x, device=self._device).clone() for x in v])
                continue
            loaded_global = loaded_global or _shard_spec.is_global_value(self, name, v)
            t = _shard_spec.local_value(self, name, v)
            if t.shape != default.shape and name not in self._shape_polymorphic_states:
                error_msgs.append(f"state {key!r}: shape {tuple(t.shape)} in the checkpoint, {tuple(default.shape)} here")
            elif t.is_floating_point() != default.is_floating_point():
                error_msgs.append(f"state {key!r}: dtype {t.dtype} in the checkpoint, {default.dtype} here")
            else:
                setattr(self, name, t.to(default.dtype).clone())
        for attr in self._dynamic_state_attrs:
            if prefix + attr in state_dict:
                setattr(self, attr, _decode_dynamic(state_dict[prefix + attr]))
        if _health.HEALTH_STATE in self._defaults:
            _health.reset_seen_mirrors(self, getattr(self, _health.HEALTH_STATE).cpu().numpy())
        if loaded_global:
            _shard_spec.mark_global(self)
        known = set(self._defaults) | set(self._dynamic_state_attrs)
        for key in state_dict:
            if key.startswith(prefix) and key[len(prefix):] not in known and "." not in key[len(prefix):]:
                unexpected_keys.append(key)
        self._computed = None

    # ------------------------------------------------------------------
    # pickling / copying
    # ------------------------------------------------------------------
    def __getstate__(self) -> Dict[str, Any]:
        """The instance's attributes without the wrappers ``__init__`` made
        and without its engine key (a program cache is per process): the
        wrappers are closures over this instance (a copy would update the
        original) and do not pickle. State tensors pickle as they are, with
        their device: a CUDA state comes back on CUDA, and ``_device`` with
        it (the JAX package turns its states into numpy instead). The process
        group is a handle to this process's communicator: a deep copy shares
        it, and a pickle leaves it out."""
        skip = (
            "update",
            "compute",
            "_update_signature",
            "_inner_update",
            "_compute_impl",
            "_engine_key",
            "_engine_key_pins",
            "_zero_row_deltas",
        )
        state = {k: v for k, v in self.__dict__.items() if k not in skip}
        if state.get("_shard_layout"):
            # the mesh is process-local: a copy carries the global states
            # (gathered, a collective of every process of the mesh) and the
            # annotations, not the placement
            state = _shard_spec.unplaced_copy(self, state)
        state["_shard_mesh"] = None
        if isinstance(state.get("process_group"), dist.ProcessGroup):
            # a store-backed ProcessGroup is a plain record and pickles as it is
            state["process_group"] = _ProcessLocal(state["process_group"])
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        """Rebuild the wrappers from the class's own methods, as ``__init__``
        does, after unpickling or ``deepcopy``. The warn-once token is issued
        anew: a copy does not share the original's warning history, and a
        pickled token could collide with one issued in this process."""
        group = state.get("process_group")
        if isinstance(group, _ProcessLocal):
            if group.handle is None:
                warnings.warn(
                    f"A pickled {type(self).__name__} comes back with process_group=None: a"
                    " torch.distributed process group belongs to the process that made it."
                    " Pass this process's group to `process_group` again before syncing.",
                    UserWarning,
                    stacklevel=2,
                )
            state = {**state, "process_group": group.handle}
        super().__setstate__(state)
        for name, value in (
            ("on_bad_input", "propagate"),
            ("health_screen", "nonfinite"),
            ("_health_warn_on_bad", False),
            ("jit_bucket", None),
            ("_enable_jit", True),
            ("_jit_failed", False),
            ("_engine_probed", False),
            ("_list_placeholders", {}),
            ("_sync_precisions", {}),
            ("axis_name", None),
            ("_state_shardings", {}),
            ("_shard_mesh", None),
            ("_shard_layout", {}),
            ("_drive_synced", False),
        ):
            self.__dict__.setdefault(name, value)
        self.__dict__.setdefault("_health_stats", _health.new_health_stats())
        self.__dict__.setdefault("_sync_stats", new_sync_stats())
        self._update_signature = inspect.signature(self.update)
        self.update = self._wrap_update(self.update)  # type: ignore[method-assign]
        self.compute = self._wrap_compute(self.compute)  # type: ignore[method-assign]
        self._warn_token = instance_token()
        # the program cache is this process's: the copy finds its entry anew
        # and counts its own dispatches; the sync and health counters
        # describe the metric and travel with it
        self._compile_stats = _engine.new_stats()

    def clone(self) -> "Metric":
        """A deep copy, with its own state and wrappers."""
        return copy.deepcopy(self)

    # ------------------------------------------------------------------
    # kwarg filtering for collections
    # ------------------------------------------------------------------
    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        var_kinds = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
        params = self._update_signature.parameters
        if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()):
            return kwargs
        return {k: v for k, v in kwargs.items() if k in params and params[k].kind not in var_kinds}

    def extra_repr(self) -> str:
        return f"device={self._device}"

    def __hash__(self) -> int:
        # identity, as nn.Module's: ``==`` builds a CompositionalMetric, and
        # the memo sets of ``named_modules`` need a hash that never changes
        return object.__hash__(self)

    # ------------------------------------------------------------------
    # operators -> CompositionalMetric
    # ------------------------------------------------------------------
    def __add__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.add, self, other)

    def __radd__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.add, other, self)

    def __sub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.sub, self, other)

    def __rsub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.sub, other, self)

    def __mul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.mul, self, other)

    def __rmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.mul, other, self)

    def __truediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.true_divide, self, other)

    def __rtruediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.true_divide, other, self)

    def __floordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.floor_divide, self, other)

    def __rfloordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.floor_divide, other, self)

    def __mod__(self, other: Any) -> "CompositionalMetric":
        # fmod: the result has the dividend's sign, as in the JAX package
        return CompositionalMetric(torch.fmod, self, other)

    def __rmod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.fmod, other, self)

    def __pow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.pow, self, other)

    def __rpow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.pow, other, self)

    def __matmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.matmul, self, other)

    def __rmatmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.matmul, other, self)

    def __and__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_and, self, other)

    def __rand__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_and, other, self)

    def __or__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_or, self, other)

    def __ror__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_or, other, self)

    def __xor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_xor, self, other)

    def __rxor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_xor, other, self)

    def __eq__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(torch.eq, self, other)

    def __ne__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(torch.ne, self, other)

    def __lt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.lt, self, other)

    def __le__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.le, self, other)

    def __gt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.gt, self, other)

    def __ge__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.ge, self, other)

    def __abs__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.abs, self, None)

    def __neg__(self) -> "CompositionalMetric":
        return CompositionalMetric(_neg, self, None)

    def __pos__(self) -> "CompositionalMetric":
        # abs, as in the JAX package
        return CompositionalMetric(torch.abs, self, None)

    def __invert__(self) -> "CompositionalMetric":
        # bitwise complement: logical on bools, two's complement on ints
        return CompositionalMetric(torch.bitwise_not, self, None)

    def __getitem__(self, idx: Any) -> "CompositionalMetric":
        return CompositionalMetric(lambda x: x[idx], self, None)


def _neg(x: torch.Tensor) -> torch.Tensor:
    # -abs, as in the JAX package
    return -torch.abs(x)


class CompositionalMetric(Metric):
    """A lazy arithmetic composition of metrics (built by the operators).

    The operand metrics are submodules and do the updates and the syncs;
    a constant operand is a buffer on their device. The composition takes
    its device from its operands, so it never falls back to the default.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy
        >>> acc = Accuracy(device="cpu")
        >>> double = acc * 2
        >>> double.update(torch.tensor([1, 0, 1, 1]), torch.tensor([1, 0, 0, 1]))
        >>> print(round(float(double.compute()), 4))
        1.5
    """

    def __init__(
        self,
        operator: Callable,
        metric_a: Union[Metric, float, int, torch.Tensor, None],
        metric_b: Union[Metric, float, int, torch.Tensor, None],
    ) -> None:
        operands = (metric_a, metric_b)
        device = next((x.device for x in operands if isinstance(x, (Metric, torch.Tensor))), None)
        super().__init__(device=device, jit_update=False)
        self.op = operator
        for name, x in zip(("metric_a", "metric_b"), operands):
            if isinstance(x, Metric):
                setattr(self, name, x)
            else:
                self.register_buffer(name, None if x is None else torch.as_tensor(x, device=self._device), persistent=False)

    def _sync_dist(self, dist_sync_fn: Optional[Callable] = None, process_group: Optional[Any] = None) -> None:
        pass  # the operands sync in their own compute()

    def update(self, *args: Any, **kwargs: Any) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.update(*args, **self.metric_a._filter_kwargs(**kwargs))
        if isinstance(self.metric_b, Metric):
            self.metric_b.update(*args, **self.metric_b._filter_kwargs(**kwargs))

    def compute(self) -> Any:
        val_a = self.metric_a.compute() if isinstance(self.metric_a, Metric) else self.metric_a
        val_b = self.metric_b.compute() if isinstance(self.metric_b, Metric) else self.metric_b
        if val_b is None:
            return self.op(val_a)
        return self.op(val_a, val_b)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        val_a = (
            self.metric_a(*args, **self.metric_a._filter_kwargs(**kwargs))
            if isinstance(self.metric_a, Metric)
            else self.metric_a
        )
        val_b = (
            self.metric_b(*args, **self.metric_b._filter_kwargs(**kwargs))
            if isinstance(self.metric_b, Metric)
            else self.metric_b
        )
        if val_a is None or (val_b is None and isinstance(self.metric_b, Metric)):
            self._forward_cache = None
        elif val_b is None:
            self._forward_cache = self.op(val_a)
        else:
            self._forward_cache = self.op(val_a, val_b)
        return self._forward_cache

    def reset(self) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.reset()
        if isinstance(self.metric_b, Metric):
            self.metric_b.reset()
        self._update_count = 0
        self._forward_cache = None
        self._computed = None

    def persistent(self, mode: bool = False) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.persistent(mode=mode)
        if isinstance(self.metric_b, Metric):
            self.metric_b.persistent(mode=mode)

    def extra_repr(self) -> str:
        return f"op={getattr(self.op, '__name__', 'op')}, device={self._device}"

"""Cross-process gathers and reductions on ``torch.distributed``
(counterpart of ``metrics_tpu/parallel/comm.py``).

Two halves, as in the JAX package:

* the host sync of ``compute()`` (below);
* the in-program collectives over the named axes of a
  ``torch.distributed.device_mesh.DeviceMesh`` (:func:`reduce_in_trace`,
  :func:`sync_state_trees`, :func:`sync_state_in_trace`, the end of this
  module), which a JAX trace runs inside ``shard_map``: one process per
  device, the mesh named by :func:`axis_env`, NCCL collectives through
  ``_functional_collectives`` so that a CUDA graph captures them.

The host sync:

A metric's states are gathered leaf by leaf with ``all_gather`` over a
process group (the default group unless one is given), on whatever backend
that group runs: NCCL with CUDA tensors, gloo with CPU or CUDA tensors. The
tensors stay where they are; nothing is copied to the host but the small
shape records of the uneven path.

* ``fixed_shape=True`` (states reduced by sum/mean/max/min, whose shape is
  fixed by registration) is one collective per leaf.
* Otherwise every rank first gathers every rank's shape and dtype, pads its
  leaf to the largest shape, gathers, and trims each rank's part back. A
  rank whose leaf is empty along dim 0 contributes nothing, and takes the
  dtype and trailing shape of the ranks that hold data; so an empty list
  state on one rank gathers beside a full one on another.

A process with no initialised default group is a world of one: the gather
returns the local tensor. An initialised world of size 1 still gathers.

A float leaf tagged ``"bf16"`` or ``"int8"`` (``add_state(sync_precision=)``)
moves its codes through the collective and is decoded on receipt
(:func:`_quantized_allgather`); a :class:`~metrics_tpu_torch.parallel.ProcessGroup`
syncs through the store instead (``parallel/groups.py``).

Telemetry: a gather given a ``report`` (a metric's sync counters,
``resilience.new_sync_stats``) counts one ``attempts``, the bytes of its
all-gathers (this rank's buffer in ``bytes_sent``, the other ranks' in
``bytes_received``) and the wire codec's raw and encoded bytes; while the
event bus records it emits one ``sync_attempt`` event with the ``world``
size and this process's ``rank``, and a ``wire`` event per quantized leaf.
"""
import threading
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from metrics_tpu_torch.obs import bus as _bus
from metrics_tpu_torch.utils.data import dim_zero_cat

#: reductions of states whose shape is fixed by registration: one collective each
SIMPLE_REDUCTIONS = ("sum", "mean", "max", "min")
# dtypes a ragged leaf may have, by code in its shape record
_DTYPES = (
    torch.bool,
    torch.uint8,
    torch.int8,
    torch.int16,
    torch.int32,
    torch.int64,
    torch.float16,
    torch.bfloat16,
    torch.float32,
    torch.float64,
)
_MAX_DIMS = 8


def _simulated_process() -> Optional[Tuple[int, int]]:
    """The (rank, world) of the fault harness's per-thread simulated world
    (``resilience.simulated_world``), or None outside it."""
    from metrics_tpu_torch.resilience import faults

    return faults.simulated_process()


def distributed_available() -> bool:
    """True when ``torch.distributed`` has an initialised default group, or
    inside a simulated world of more than one process (the fault harness,
    which carries the :class:`~metrics_tpu_torch.parallel.ProcessGroup`
    store sync and custom ``dist_sync_fn``s)."""
    sim = _simulated_process()
    if sim is not None:
        return sim[1] > 1
    return dist.is_available() and dist.is_initialized()


def world_size(group: Optional[Any] = None) -> int:
    """Ranks in ``group`` (the default group when None); 1 without one; the
    simulated world's size inside one."""
    sim = _simulated_process()
    if sim is not None:
        return sim[1]
    return dist.get_world_size(group) if dist.is_available() and dist.is_initialized() else 1


def process_index(group: Optional[Any] = None) -> int:
    """This process's rank in ``group`` (the default group when None); 0
    without one; the simulated rank inside a simulated world."""
    sim = _simulated_process()
    if sim is not None:
        return sim[0]
    return dist.get_rank(group) if dist.is_available() and dist.is_initialized() else 0


def _all_gather_flat(x: torch.Tensor, group: Optional[Any], report: Optional[Dict[str, Any]] = None) -> List[torch.Tensor]:
    """One ``all_gather`` of ``x`` flattened: every rank's buffer, flat."""
    flat = x.reshape(-1).contiguous()
    world = dist.get_world_size(group)
    out = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(out, flat, group=group)
    if report is not None:
        nbytes = flat.numel() * flat.element_size()
        report["bytes_sent"] += nbytes
        report["bytes_received"] += nbytes * (world - 1)
    return out


def _quantized_allgather(
    x: torch.Tensor, codec: str, group: Optional[Any], report: Optional[Dict[str, Any]]
) -> List[torch.Tensor]:
    """Every rank's ``x`` (all of one shape and dtype), moving the codec's
    narrow form: encode on ``x``'s device, gather the codes (and, for int8,
    the block scales), decode every rank's part back to ``x``'s dtype.
    Exact payloads gather as they are and count toward the wire totals
    too, so the reduction ratio compares across paths."""
    from metrics_tpu_torch.parallel import quantize as _quant

    if codec == "exact":
        _quant.record_wire("exact", _quant.nbytes(x), _quant.nbytes(x), stats=report)
        return [o.reshape(x.shape) for o in _all_gather_flat(x, group, report)]
    qdata, scales, _ = _quant.quantize_array(x, codec)
    if qdata.dtype == torch.bfloat16:
        # the codes travel as their 16 bits in a float16 view, which every
        # backend gathers (a copy, so the bits arrive as they left)
        gathered_q = [q.view(torch.bfloat16) for q in _all_gather_flat(qdata.view(torch.float16), group, report)]
    else:
        gathered_q = _all_gather_flat(qdata, group, report)
    gathered_s = _all_gather_flat(scales, group, report) if scales is not None else None
    shape = tuple(x.shape)
    out = [
        _quant.dequantize_array(q, gathered_s[i] if gathered_s is not None else None, codec, x.dtype, shape)
        for i, q in enumerate(gathered_q)
    ]
    # the counters cover this rank's contribution, as on the store path; the
    # round-trip error is read on this rank's own decoded part
    own = out[dist.get_rank(group)]
    error = float((x.to(torch.float32) - own.to(torch.float32)).abs().max()) if x.numel() else 0.0
    encoded = _quant.nbytes(qdata) + (_quant.nbytes(scales) if scales is not None else 0)
    _quant.record_wire(codec, _quant.nbytes(x), encoded, error=error, stats=report)
    if _bus.enabled():
        _bus.emit(
            "wire",
            source="torch.distributed",
            codec=codec,
            bytes_raw=_quant.nbytes(x),
            bytes_encoded=encoded,
            max_dequant_error=error,
        )
    return out


def _shape_record(x: torch.Tensor) -> torch.Tensor:
    if x.ndim > _MAX_DIMS:
        raise ValueError(f"cannot gather a tensor of {x.ndim} dims; at most {_MAX_DIMS}")
    present = x.ndim == 0 or x.shape[0] > 0
    record = [int(present), _DTYPES.index(x.dtype), x.ndim, *x.shape]
    return torch.tensor(record + [0] * (3 + _MAX_DIMS - len(record)), dtype=torch.int64, device=x.device)


def gather_all_arrays(
    x: torch.Tensor,
    group: Optional[Any] = None,
    policy: str = "raise",
    report: Optional[Dict[str, Any]] = None,
    fixed_shape: bool = False,
    precision: Optional[str] = None,
) -> List[torch.Tensor]:
    """Every rank's ``x``, in rank order, on ``x``'s device.

    Args:
        x: this rank's tensor.
        group: a ``torch.distributed.ProcessGroup`` (the default group when
            None), or a :class:`~metrics_tpu_torch.parallel.ProcessGroup`,
            whose members exchange through the store
            (:func:`~metrics_tpu_torch.parallel.groups.gather_group_arrays`).
        policy: ``"partial"`` returns, on a store group, only the members
            that delivered within its deadline (missing ranks in
            ``report``); a ``torch.distributed`` gather is one collective
            with no partial result.
        report: sync counters to count the attempt, its bytes and the wire
            codec's bytes into.
        fixed_shape: every rank's ``x`` has the same shape and dtype by
            registration; skips the shape exchange (one collective, not two).
        precision: the wire codec (``add_state(sync_precision=)``): a float
            ``x`` tagged ``"bf16"`` or ``"int8"`` moves its codes (and int8
            scales) through the collective, on the fixed-shape path and the
            ragged pad-to-max path alike, and is decoded on receipt; integer
            and bool leaves, and the shape exchange, stay exact.
    """
    from metrics_tpu_torch.parallel import quantize as _quant
    from metrics_tpu_torch.parallel.groups import ProcessGroup, gather_group_arrays

    if isinstance(group, ProcessGroup):
        return gather_group_arrays(x, group, policy=policy, report=report, precision=precision)
    if _simulated_process() is not None:
        from metrics_tpu_torch.utils.exceptions import MetricsUserError

        # a torch.distributed gather would answer for a world of one here
        raise MetricsUserError(
            "The fault-injection harness's simulated world only carries ProcessGroup (store) syncs; a"
            " torch.distributed gather has no simulated backend. Construct the metric with"
            " process_group=new_group(range(world)) (or a custom dist_sync_fn) to sync under"
            " simulated_world/run_as_peers."
        )
    if not distributed_available():
        return [x]
    if group is not None and dist.get_rank(group) < 0:
        raise ValueError("this process is not a member of the `process_group` it was asked to gather over")
    if report is not None:
        report["attempts"] += 1
    if _bus.enabled():
        _bus.emit("sync_attempt", source="torch.distributed", world=dist.get_world_size(group), rank=dist.get_rank(group))
    if fixed_shape:
        return _quantized_allgather(x, _quant.resolve_codec(precision, x.dtype), group, report)

    records = torch.stack(_all_gather_flat(_shape_record(x), group, report)).tolist()
    holders = [r for r in records if r[0]]
    if not holders:  # every rank's leaf is empty
        return [x for _ in records]
    _, code, ndim = holders[0][:3]
    if any(r[1] != code or r[2] != ndim for r in holders):
        found = sorted({(str(_DTYPES[r[1]]), r[2]) for r in holders})
        raise ValueError(f"ranks hold this state with different dtypes or ranks (dtype, ndim): {found}")
    dtype = _DTYPES[code]
    # the holders' dtype picks the codec, the same on every rank
    codec = _quant.resolve_codec(precision, dtype)
    max_shape = [max(r[3 + d] for r in holders) for d in range(ndim)]
    shapes = [r[3 : 3 + ndim] if r[0] else [0, *max_shape[1:]] for r in records]
    if all(s == max_shape for s in shapes):
        return _quantized_allgather(x.reshape(max_shape), codec, group, report)
    padded = torch.zeros(max_shape, dtype=dtype, device=x.device)
    if x.numel():
        padded[tuple(slice(0, d) for d in x.shape)] = x
    # zero padding quantizes exactly (code 0)
    gathered = _quantized_allgather(padded, codec, group, report)
    return [g[tuple(slice(0, d) for d in s)] for g, s in zip(gathered, shapes)]


def host_reduce(
    x: torch.Tensor, reduce_fx: Union[str, Callable, None], group: Optional[Any] = None, state: Optional[str] = None
) -> Any:
    """Gather ``x`` from every rank of ``group`` and reduce it by ``reduce_fx``.

    ``state`` names the metric state in the error for an unknown reduction.
    """
    if reduce_fx not in (*SIMPLE_REDUCTIONS, "cat", None) and not callable(reduce_fx):
        raise _unsupported_fx(reduce_fx, state)
    gathered = gather_all_arrays(x, group, fixed_shape=reduce_fx in SIMPLE_REDUCTIONS)
    return reduce_gathered(gathered, reduce_fx)


def reduce_gathered(gathered: List[torch.Tensor], reduce_fx: Union[str, Callable, None]) -> torch.Tensor:
    """Reduce one state's per-rank tensors: ``cat`` joins them along dim 0,
    sum/mean/max/min reduce them elementwise, ``None`` stacks them and a
    callable takes the stack."""
    if reduce_fx == "cat":
        return torch.cat([torch.atleast_1d(g) for g in gathered], dim=0)
    if reduce_fx is None:
        return torch.stack([torch.atleast_1d(g) for g in gathered], dim=0)
    stacked = torch.stack(gathered, dim=0)
    if reduce_fx == "sum":
        return stacked.sum(dim=0)
    if reduce_fx == "mean":
        return (stacked if stacked.is_floating_point() else stacked.to(torch.get_default_dtype())).mean(dim=0)
    if reduce_fx == "max":
        return stacked.amax(dim=0)
    if reduce_fx == "min":
        return stacked.amin(dim=0)
    if callable(reduce_fx):
        return reduce_fx(stacked)
    raise ValueError(f"Unsupported dist_reduce_fx: {reduce_fx!r}")


def class_reduce(
    num: torch.Tensor, denom: torch.Tensor, weights: torch.Tensor, class_reduction: Optional[str] = "none"
) -> torch.Tensor:
    """Per-class score reduction: ``micro``, ``macro``, ``weighted`` or ``none``."""
    valid_reduction = ("micro", "macro", "weighted", "none", None)
    fraction = num.sum() / denom.sum() if class_reduction == "micro" else num / denom
    fraction = torch.nan_to_num(fraction, nan=0.0, posinf=0.0, neginf=0.0)
    if class_reduction == "micro":
        return fraction
    if class_reduction == "macro":
        return fraction.mean()
    if class_reduction == "weighted":
        return (fraction * (weights / weights.sum())).sum()
    if class_reduction in ("none", None):
        return fraction
    raise ValueError(f"Reduction parameter {class_reduction!r} unknown. Choose between one of these: {valid_reduction}")


def reduce(x: torch.Tensor, reduction: Optional[str]) -> torch.Tensor:
    """``elementwise_mean``, ``sum`` or ``none`` over all elements."""
    if reduction == "elementwise_mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    if reduction in ("none", None):
        return x
    raise ValueError("Reduction parameter unknown.")


# ---------------------------------------------------------------------------
# In-program collectives over the axes of a DeviceMesh (the in-trace half of
# metrics_tpu/parallel/comm.py)
# ---------------------------------------------------------------------------
_AXIS_ENV = threading.local()


@contextmanager
def axis_env(mesh: Any) -> Iterator[Any]:
    """Name the mesh whose axes ``axis_name`` arguments refer to inside the
    block (what a ``shard_map`` gives a JAX trace): :func:`reduce_in_trace`,
    :func:`sync_state_trees`, ``Metric.sync_state(state, axis_name)`` and
    ``MetricCollection.sync_state(states, axis_name)`` read it."""
    stack = _AXIS_ENV.__dict__.setdefault("stack", [])
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def current_mesh(mesh: Optional[Any] = None) -> Any:
    """``mesh``, else the innermost :func:`axis_env` mesh; raises without one."""
    if mesh is not None:
        return mesh
    stack = _AXIS_ENV.__dict__.get("stack") or []
    if not stack:
        raise ValueError(
            "an axis_name collective needs a DeviceMesh: run it inside `comm.axis_env(mesh)` (as"
            " `drive(mesh=, axis_name=)` does) or pass `mesh=`"
        )
    return stack[-1]


def mesh_spans_processes(mesh: Optional[Any]) -> bool:
    """True when a mesh's devices belong to more than one process: with one
    process per device, a mesh of more than one device. After a mesh drive
    over such a mesh the states are already the global ones, and the host
    sync must be disarmed."""
    return mesh is not None and int(mesh.size()) > 1


def _axes_tuple(axis_name: Union[str, Sequence[str]]) -> Tuple[str, ...]:
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


_FLAT_GROUPS: Dict[Tuple[int, Tuple[str, ...]], Any] = {}


def axis_group(mesh: Any, axis_name: Union[str, Sequence[str]]) -> Any:
    """The process group over the mesh axis, or over several axes as one
    flat group (in row-major rank order, made once per mesh and axes: a
    collective call of every process of the mesh)."""
    axes = _axes_tuple(axis_name)
    names = tuple(mesh.mesh_dim_names or ())
    missing = [a for a in axes if a not in names]
    if missing:
        raise ValueError(f"axis {missing} is not a dim of the mesh {names}")
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
        raise ValueError(f"axis_name {axes} must name the mesh dims in the mesh's order {names}")
    key = (id(mesh), axes)
    if key not in _FLAT_GROUPS:
        _FLAT_GROUPS[key] = (mesh, mesh[axes]._flatten().get_group())
    return _FLAT_GROUPS[key][1]


def axis_world(mesh: Any, axis_name: Union[str, Sequence[str]]) -> int:
    """Processes along the named axis, or the product over several."""
    names = tuple(mesh.mesh_dim_names or ())
    n = 1
    for a in _axes_tuple(axis_name):
        n *= int(mesh.shape[names.index(a)])
    return n


def axis_index(mesh: Any, axis_name: Union[str, Sequence[str]]) -> int:
    """This process's row-major index along the named axes."""
    names = tuple(mesh.mesh_dim_names or ())
    idx = 0
    for a in _axes_tuple(axis_name):
        idx = idx * int(mesh.shape[names.index(a)]) + int(mesh.get_local_rank(a))
    return idx


def _in_program_backend(group: Any) -> bool:
    """NCCL collectives run through ``torch.distributed._functional_collectives``,
    which a CUDA graph captures; others (gloo) through the eager ops."""
    return dist.get_backend(group) == "nccl"


_DIST_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def live_axes(mesh: Any, axes: Sequence[str]) -> Tuple[str, ...]:
    """The axes a sync must run a collective over: those of more than one
    process, and every NCCL one (a group of one still runs its collective,
    so that a program holds it as it would at scale)."""
    return tuple(a for a in axes if axis_world(mesh, a) > 1 or _in_program_backend(axis_group(mesh, a)))


def _all_reduce(x: torch.Tensor, op: str, group: Any) -> torch.Tensor:
    in_program = _in_program_backend(group)
    if dist.get_world_size(group) == 1 and not in_program:
        return x.clone()
    if in_program:
        import torch.distributed._functional_collectives as fc

        return fc.wait_tensor(fc.all_reduce(x.contiguous(), op, group))
    out = x.clone().contiguous()
    dist.all_reduce(out, op=_DIST_OPS[op], group=group)
    return out


def _all_gather_stack(x: torch.Tensor, group: Any) -> torch.Tensor:
    """``[world, *x.shape]``: every process's ``x`` in rank order."""
    world = dist.get_world_size(group)
    in_program = _in_program_backend(group)
    if world == 1 and not in_program:
        return x.unsqueeze(0).clone()
    if in_program:
        import torch.distributed._functional_collectives as fc

        flat = fc.wait_tensor(fc.all_gather_tensor(x.contiguous().reshape(1, -1), 0, group))
        return flat.reshape((world, *x.shape))
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


def _mean(total: torch.Tensor, n: int) -> torch.Tensor:
    if total.is_floating_point() or total.is_complex():
        return total / n
    return torch.div(total, n, rounding_mode="trunc")


def _staged_axes(axis_name: Union[str, Sequence[str]], hierarchical: bool) -> Optional[Tuple[str, ...]]:
    """The axes to reduce stage by stage (inner first), or None for one flat
    collective: staging needs ``hierarchical=True`` and two or more axes."""
    if not hierarchical or isinstance(axis_name, str):
        return None
    axes = tuple(axis_name)
    return axes if len(axes) >= 2 else None


def _unsupported_fx(reduce_fx: Any, state: Optional[str]) -> ValueError:
    where = f" for state {state!r}" if state else ""
    return ValueError(f"Unsupported dist_reduce_fx{where}: {reduce_fx!r}")


def reduce_in_trace(
    x: torch.Tensor,
    reduce_fx: Union[str, Callable, None],
    axis_name: Union[str, Sequence[str]],
    hierarchical: bool = False,
    state: Optional[str] = None,
    *,
    mesh: Optional[Any] = None,
) -> torch.Tensor:
    """One reduction of ``x`` across the named mesh axes.

    ``sum/max/min`` are all-reduces and ``mean`` their sum over the axis
    size; ``cat`` is a tiled all-gather (rank-major along dim 0), ``None`` a
    stacking all-gather (a new leading axis) and a callable takes that
    stack. The shapes are the same on every process, as inside a JAX
    trace. ``hierarchical=True`` with two or more axes (outer first, as
    ``("host", "local")``) stages sum/mean/max/min/cat inner axis first:
    integer sums, max and min equal the flat collective bit for bit, and
    the staged ``cat`` keeps the flat order; ``None`` and callables always
    run flat. On NCCL the collectives are ``_functional_collectives``,
    which a CUDA graph captures; on gloo they are the eager ops. ``state``
    (``"member.state"``) names the state in the error for an unknown
    reduction. ``mesh`` defaults to the :func:`axis_env` mesh."""
    if reduce_fx not in (*SIMPLE_REDUCTIONS, "cat", None) and not callable(reduce_fx):
        raise _unsupported_fx(reduce_fx, state)
    mesh = current_mesh(mesh)
    axes = _staged_axes(axis_name, hierarchical)
    if axes is not None and reduce_fx in (*SIMPLE_REDUCTIONS, "cat"):
        out = torch.atleast_1d(x) if reduce_fx == "cat" else x
        for ax in reversed(axes):
            out = _reduce_one(out, reduce_fx, mesh, ax)
        return out
    return _reduce_one(x, reduce_fx, mesh, axis_name)


def _reduce_one(x: torch.Tensor, reduce_fx: Any, mesh: Any, axis_name: Any) -> torch.Tensor:
    group = axis_group(mesh, axis_name)
    if reduce_fx in ("sum", "max", "min"):
        return _all_reduce(x, reduce_fx, group)
    if reduce_fx == "mean":
        return _mean(_all_reduce(x, "sum", group), dist.get_world_size(group))
    stacked = _all_gather_stack(torch.atleast_1d(x) if reduce_fx == "cat" else x, group)
    if reduce_fx == "cat":
        return stacked.reshape((-1, *stacked.shape[2:]))
    if reduce_fx is None:
        return stacked
    return reduce_fx(stacked)


def empty_placeholder(spec: Optional[Any], device: Optional[Any] = None) -> torch.Tensor:
    """A zero-length contribution for an empty list state: the declared
    ``(shape, dtype)`` (``add_state(placeholder=)``, or anything with
    ``shape`` and ``dtype``), else a zero-length float32 vector."""
    if spec is None:
        return torch.zeros((0,), device=device)
    shape, dtype = (spec.shape, spec.dtype) if hasattr(spec, "shape") else spec
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def sync_state_trees(
    states: dict,
    reductions: dict,
    axis_name: Union[str, Sequence[str]],
    placeholders: Optional[dict] = None,
    hierarchical: bool = False,
    *,
    mesh: Optional[Any] = None,
) -> dict:
    """Several metrics' state dicts (member key -> state dict) synced across
    the named axes, one collective per state. A list state is concatenated
    first and comes back as a one-element list; an empty one contributes
    its declared placeholder (``placeholders``: member key -> the metric's
    ``_list_placeholders``), and when it is empty on every process (shapes
    are uniform, as in a trace) it is returned as it is, with no
    collective. See :func:`reduce_in_trace` for ``hierarchical``."""
    out: dict = {key: {} for key in states}
    for key, state in states.items():
        member_reductions = reductions[key]
        member_placeholders = (placeholders or {}).get(key) or {}
        for name, value in state.items():
            fx = member_reductions.get(name)
            if isinstance(value, list):
                device = value[0].device if value else None
                value = dim_zero_cat(value) if value else empty_placeholder(member_placeholders.get(name), device)
                if value.shape[0] == 0:
                    out[key][name] = [value]
                else:
                    out[key][name] = [
                        reduce_in_trace(
                            value,
                            "cat" if fx in (None, "cat") else fx,
                            axis_name,
                            hierarchical=hierarchical,
                            state=f"{key}.{name}",
                            mesh=mesh,
                        )
                    ]
            else:
                out[key][name] = reduce_in_trace(
                    value, fx, axis_name, hierarchical=hierarchical, state=f"{key}.{name}", mesh=mesh
                )
    return out


def sync_state_in_trace(
    state: dict,
    reductions: dict,
    axis_name: Union[str, Sequence[str]],
    placeholders: Optional[dict] = None,
    hierarchical: bool = False,
    *,
    mesh: Optional[Any] = None,
) -> dict:
    """One state dict synced across the named axes: the single-metric view
    of :func:`sync_state_trees`."""
    return sync_state_trees(
        {"_": state},
        {"_": reductions},
        axis_name,
        placeholders={"_": placeholders or {}},
        hierarchical=hierarchical,
        mesh=mesh,
    )["_"]

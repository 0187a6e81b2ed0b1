"""Cross-process gathers and reductions on ``torch.distributed``
(counterpart of the host-level half of ``metrics_tpu/parallel/comm.py``).

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

Telemetry: a gather given a ``report`` (a metric's sync counters,
``resilience.new_sync_stats``) counts one ``attempts`` and the bytes of
its all-gathers, this rank's buffer in ``bytes_sent`` and the other
ranks' in ``bytes_received``; while the event bus records it emits one
``sync_attempt`` event with the ``world`` size and this process's
``rank``.
"""
from typing import Any, Callable, Dict, List, Optional, Union

import torch
import torch.distributed as dist

from metrics_tpu_torch.obs import bus as _bus

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


def distributed_available() -> bool:
    """True when ``torch.distributed`` has an initialised default group."""
    return dist.is_available() and dist.is_initialized()


def world_size(group: Optional[Any] = None) -> int:
    """Ranks in ``group`` (the default group when None); 1 without one."""
    return dist.get_world_size(group) if distributed_available() else 1


def process_index(group: Optional[Any] = None) -> int:
    """This process's rank in ``group`` (the default group when None); 0 without one."""
    return dist.get_rank(group) if distributed_available() else 0


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


def _shape_record(x: torch.Tensor) -> torch.Tensor:
    if x.ndim > _MAX_DIMS:
        raise ValueError(f"cannot gather a tensor of {x.ndim} dims; at most {_MAX_DIMS}")
    present = x.ndim == 0 or x.shape[0] > 0
    record = [int(present), _DTYPES.index(x.dtype), x.ndim, *x.shape]
    return torch.tensor(record + [0] * (3 + _MAX_DIMS - len(record)), dtype=torch.int64, device=x.device)


def gather_all_arrays(
    x: torch.Tensor, group: Optional[Any] = None, fixed_shape: bool = False, report: Optional[Dict[str, Any]] = None
) -> List[torch.Tensor]:
    """Every rank's ``x``, in rank order, on ``x``'s device.

    Args:
        x: this rank's tensor.
        group: a ``torch.distributed.ProcessGroup``; the default group when None.
        fixed_shape: every rank's ``x`` has the same shape and dtype by
            registration; skips the shape exchange (one collective, not two).
        report: sync counters to count the attempt and its bytes into.
    """
    if not distributed_available():
        return [x]
    if group is not None and dist.get_rank(group) < 0:
        raise ValueError("this process is not a member of the `process_group` it was asked to gather over")
    if report is not None:
        report["attempts"] += 1
    if _bus.enabled():
        _bus.emit("sync_attempt", source="torch.distributed", world=dist.get_world_size(group), rank=dist.get_rank(group))
    if fixed_shape:
        return [o.reshape(x.shape) for o in _all_gather_flat(x, group, report)]

    records = torch.stack(_all_gather_flat(_shape_record(x), group, report)).tolist()
    holders = [r for r in records if r[0]]
    if not holders:  # every rank's leaf is empty
        return [x for _ in records]
    _, code, ndim = holders[0][:3]
    if any(r[1] != code or r[2] != ndim for r in holders):
        found = sorted({(str(_DTYPES[r[1]]), r[2]) for r in holders})
        raise ValueError(f"ranks hold this state with different dtypes or ranks (dtype, ndim): {found}")
    dtype = _DTYPES[code]
    max_shape = [max(r[3 + d] for r in holders) for d in range(ndim)]
    shapes = [r[3 : 3 + ndim] if r[0] else [0, *max_shape[1:]] for r in records]
    if all(s == max_shape for s in shapes):
        return [o.reshape(max_shape) for o in _all_gather_flat(x, group, report)]
    padded = torch.zeros(max_shape, dtype=dtype, device=x.device)
    if x.numel():
        padded[tuple(slice(0, d) for d in x.shape)] = x
    gathered = _all_gather_flat(padded, group, report)
    return [g.reshape(max_shape)[tuple(slice(0, d) for d in s)] for g, s in zip(gathered, shapes)]


def host_reduce(
    x: torch.Tensor, reduce_fx: Union[str, Callable, None], group: Optional[Any] = None, state: Optional[str] = None
) -> Any:
    """Gather ``x`` from every rank of ``group`` and reduce it by ``reduce_fx``.

    ``state`` names the metric state in the error for an unknown reduction.
    """
    if reduce_fx not in (*SIMPLE_REDUCTIONS, "cat", None) and not callable(reduce_fx):
        where = f" for state {state!r}" if state else ""
        raise ValueError(f"Unsupported dist_reduce_fx{where}: {reduce_fx!r}")
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

"""Kernel registry: one entry per hand-written kernel and its plain version
(counterpart of ``metrics_tpu/ops/registry.py``).

The device of the input decides the path, and nothing else does:

* a CUDA tensor launches the kernel; an input the kernel cannot take raises
  ``ValueError`` naming the reason, and never reaches the plain version;
* a CPU tensor runs the plain PyTorch version.

There is no policy switch and no fallback. Each kernel wrapper calls
:func:`count_launch` right after its launch succeeded, so
:func:`kernel_stats` shows which path a run really took: it lists the ops
that ran since the last reset, and no other.

Inside a CUDA graph capture a wrapper's launch is recorded, not run: the
engine wraps each capture in :func:`recording`, which takes the launches
the capture saw out of the counts, and credits them with :func:`credit` on
every replay of the graph (``engine/cache.py``). The counts therefore stay
the launches the card ran.

While the event bus records, every dispatch that Python runs emits one
``kernel`` event (``op``, ``path`` ``cuda`` or ``plain``, ``reason``): each
plain call on the CPU, each eager launch on the card and each launch a
capture records. A graph replay runs no Python and emits none; its launches
are credited in :func:`kernel_stats`. (The JAX package emits at trace time,
so there too a compiled program's later runs emit nothing.)
"""
import threading
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, NamedTuple, Tuple

import torch

from metrics_tpu_torch.obs import bus as _bus
from metrics_tpu_torch.utils.program import suspend_guard


class KernelOp(NamedTuple):
    """One registry entry."""

    name: str
    #: Launches the CUDA kernel on CUDA tensors.
    kernel: Callable[..., Any]
    #: Plain PyTorch version of the same function; the CPU path and the
    #: reference the kernel is held against.
    plain: Callable[..., Any]
    #: ``(*args, **kwargs) -> (ok, reason)``: what both paths accept.
    eligible: Callable[..., Tuple[bool, str]]


_REGISTRY: Dict[str, KernelOp] = {}
_LOCK = threading.Lock()
_STATS: Dict[str, Dict[str, int]] = {}


def register(op: KernelOp) -> KernelOp:
    with _LOCK:
        _REGISTRY[op.name] = op
    return op


def registered_ops() -> Tuple[str, ...]:
    """The names of the registered ops, sorted."""
    with _LOCK:
        return tuple(sorted(_REGISTRY))


def get_op(name: str) -> KernelOp:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"Unknown kernel op {name!r}; registered: {sorted(_REGISTRY)}") from None


def _device_of(args: Tuple, kwargs: Dict) -> torch.device:
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            return a.device
    raise ValueError("kernel dispatch needs at least one tensor argument")


def dispatch(name: str, *args: Any, **kwargs: Any) -> Any:
    """Run op ``name``: its kernel for CUDA inputs, its plain version for CPU inputs."""
    op = get_op(name)
    ok, why = op.eligible(*args, **kwargs)
    if not ok:
        raise ValueError(f"kernel op {name!r} does not take these inputs: {why}")
    device = _device_of(args, kwargs)
    if device.type == "cuda":
        if _bus.enabled():
            _bus.emit("kernel", source=name, op=name, path="cuda", reason="cuda_input")
        return op.kernel(*args, **kwargs)
    if device.type == "cpu":
        _count(name, "plain_calls")
        if _bus.enabled():
            _bus.emit("kernel", source=name, op=name, path="plain", reason="cpu_input")
        # on the card this op is one kernel that never syncs: its plain
        # version's host-side work does not count against an update program
        with suspend_guard():
            return op.plain(*args, **kwargs)
    raise ValueError(f"kernel op {name!r} has no path for device {device}")


_RECORDING = threading.local()


def _count(name: str, key: str) -> None:
    with _LOCK:
        _STATS.setdefault(name, {"launches": 0, "plain_calls": 0})[key] += 1


def count_launch(name: str) -> None:
    """Called by a kernel wrapper once its kernel launched without error
    (or, inside :func:`recording`, once it was recorded into a graph)."""
    recorder = getattr(_RECORDING, "launches", None)
    if recorder is not None:
        recorder[name] = recorder.get(name, 0) + 1
        return
    _count(name, "launches")


@contextmanager
def recording() -> Iterator[Dict[str, int]]:
    """Collect the launches of the enclosed code into the yielded dict
    instead of the counts (a CUDA graph capture, which runs nothing)."""
    outer = getattr(_RECORDING, "launches", None)
    launches: Dict[str, int] = {}
    _RECORDING.launches = launches
    try:
        yield launches
    finally:
        _RECORDING.launches = outer


def credit(launches: Dict[str, int]) -> None:
    """Count ``launches`` (op -> n) as run: one replay of a captured graph."""
    with _LOCK:
        for name, n in launches.items():
            _STATS.setdefault(name, {"launches": 0, "plain_calls": 0})["launches"] += n


def kernel_stats() -> Dict[str, Dict[str, int]]:
    """``{op: {"launches": n, "plain_calls": m}}`` for each op that ran since the last reset."""
    with _LOCK:
        return {name: dict(rec) for name, rec in sorted(_STATS.items())}


def reset_kernel_stats() -> None:
    with _LOCK:
        _STATS.clear()

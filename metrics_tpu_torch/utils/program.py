"""The in-program flag and the host-sync guard of the update engine
(counterpart of ``metrics_tpu/utils/data.py:20`` ``is_tracing``).

The JAX package knows that an update runs inside a compiled program because
its inputs are tracers: the value checks skip, and anything that needs a
concrete value (``bool(x)``, ``int(x)``, a boolean mask) raises, which sends
the metric to its eager fallback. The port runs the same update body eagerly
on the CPU and captures it into a CUDA graph on the card, so it needs both
halves spelled out:

* :func:`in_program` is True while the engine runs a transition, on either
  device. The value checks of ``utils/checks.py`` skip under it, as the JAX
  ones skip under tracing.
* :func:`program_scope` also installs a ``TorchFunctionMode`` that raises
  :class:`~metrics_tpu_torch.utils.exceptions.JitIncompatibleError` on every
  tensor operation that waits for the device or sizes its output by the
  data (``.item()``, ``bool()``, ``.tolist()``, ``nonzero``, a boolean mask,
  ``bincount`` ...), and on a tensor made from host data on a named device
  (``torch.tensor(n, device=...)``, a host-to-device copy). On the card such
  an operation breaks a graph capture;
  raising it on the CPU too makes both devices fall back to the eager update
  at the same place, as a failed ``jax.jit`` trace does.

A kernel op's plain version (``ops/registry.py``) runs with the guard
suspended: on the card the op is one kernel that never syncs, so the plain
version's own host-side work must not count against the caller.
"""
import threading
from contextlib import contextmanager
from typing import Any, Iterator

import torch
from torch.overrides import TorchFunctionMode

from metrics_tpu_torch.utils.exceptions import JitIncompatibleError

_STATE = threading.local()

#: Tensor methods and functions that wait for the device or size their
#: output by the data; each one breaks a CUDA graph capture.
_SYNCING = frozenset(
    (
        "__bool__", "__int__", "__float__", "__index__", "__complex__", "__format__", "__repr__",
        "item", "tolist", "numpy", "cpu", "nonzero", "argwhere", "unique", "unique_consecutive",
        "masked_select", "bincount", "repeat_interleave", "nonzero_static",
    )
)


def in_program() -> bool:
    """True while the engine runs a metric transition (the port's ``is_tracing``)."""
    return getattr(_STATE, "depth", 0) > 0


def _is_bool_index(index: Any) -> bool:
    items = index if isinstance(index, tuple) else (index,)
    return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in items)


def _to_host(args: Any, kwargs: Any) -> bool:
    """``x.to(...)`` from a device to the host (a no-op from the host)."""
    if not args or not isinstance(args[0], torch.Tensor) or args[0].device.type == "cpu":
        return False
    dev = kwargs.get("device") if kwargs else None
    if dev is None:
        dev = next((a for a in args[1:] if isinstance(a, (str, torch.device))), None)
    return dev is not None and torch.device(dev).type == "cpu"


def _from_host(args: Any, kwargs: Any) -> bool:
    """``torch.tensor(data, device=...)`` from host data: a host-to-device
    copy, which a capture refuses (make a fill with ``torch.full``)."""
    return bool(kwargs) and kwargs.get("device") is not None and bool(args) and not isinstance(args[0], torch.Tensor)


class _HostSyncGuard(TorchFunctionMode):
    def __torch_function__(self, func: Any, types: Any, args: Any = (), kwargs: Any = None) -> Any:
        if getattr(_STATE, "suspended", 0) == 0:
            name = getattr(func, "__name__", "")
            if (
                name in _SYNCING
                or (name == "__getitem__" and len(args) > 1 and _is_bool_index(args[1]))
                or (name == "to" and _to_host(args, kwargs))
                or (name == "where" and len(args) + len(kwargs or {}) == 1)
                or (name in ("tensor", "as_tensor") and _from_host(args, kwargs))
            ):
                raise JitIncompatibleError(
                    f"`{name}` waits for the device or sizes its output by the data, which a captured"
                    " update program cannot do; the metric falls back to its eager update."
                )
        return func(*args, **(kwargs or {}))


@contextmanager
def program_scope(guard: bool = True) -> Iterator[None]:
    """Run the enclosed transition as a program: the flag set and, with
    ``guard``, the host-sync guard on. ``guard=False`` runs eager code with
    the value checks skipped (what they cost alone can be measured so)."""
    _STATE.depth = getattr(_STATE, "depth", 0) + 1
    try:
        if guard:
            with _HostSyncGuard():
                yield
        else:
            yield
    finally:
        _STATE.depth -= 1


@contextmanager
def suspend_guard() -> Iterator[None]:
    """Let the enclosed code sync (a kernel op's plain version)."""
    _STATE.suspended = getattr(_STATE, "suspended", 0) + 1
    try:
        yield
    finally:
        _STATE.suspended -= 1

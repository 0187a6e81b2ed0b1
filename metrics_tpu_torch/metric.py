"""``Metric`` base class: state registry and lifecycle (counterpart of
``metrics_tpu/metric.py``; the engine, health screening, tracing spans and
cross-process sync are not part of this package yet).

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
"""
import copy
import enum
import functools
import inspect
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from metrics_tpu_torch.obs.warn import instance_token, warn_once
from metrics_tpu_torch.utils import enums as _enums
from metrics_tpu_torch.utils.data import _squeeze_if_scalar
from metrics_tpu_torch.utils.exceptions import MetricsUserError

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


class Metric(nn.Module):
    """Base class for all metrics.

    Subclasses register states with :meth:`add_state` and implement
    ``update(self, ...)`` and ``compute(self)``.

    Args:
        compute_on_step: return the batch value from ``forward``.
        device: where the states live and the kernels run; ``None`` is the
            GPU, and raises when CUDA is not available.
    """

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = None
    #: Attributes learned during ``update`` that a checkpoint must carry.
    _dynamic_state_attrs: Tuple[str, ...] = ()

    def __init__(self, compute_on_step: bool = True, device: Optional[Union[str, torch.device]] = None) -> None:
        super().__init__()
        self._device = resolve_device(device)
        self._warn_token = instance_token()
        self.compute_on_step = compute_on_step
        self._update_signature = inspect.signature(self.update)
        self.update: Callable = self._wrap_update(self.update)  # type: ignore[method-assign]
        self.compute: Callable = self._wrap_compute(self.compute)  # type: ignore[method-assign]
        self._computed: Any = None
        self._forward_cache: Any = None
        self._update_count = 0
        self._defaults: Dict[str, Union[torch.Tensor, List]] = {}
        self._persistent: Dict[str, bool] = {}
        self._reductions: Dict[str, Optional[str]] = {}

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
        dist_reduce_fx: Optional[str] = None,
        persistent: bool = False,
    ) -> None:
        """Register a state: a tensor (any array-like is converted and put on
        the metric's device) or an empty list; ``dist_reduce_fx`` one of
        ``"sum"/"mean"/"max"/"min"/"cat"`` or ``None``."""
        if isinstance(default, list):
            if default:
                raise ValueError("state defaults that are lists must be empty")
        elif isinstance(default, (torch.Tensor, np.ndarray, float, int)):
            default = torch.as_tensor(default, device=self._device)
        else:
            raise ValueError("state variable must be a tensor or an empty list")
        if dist_reduce_fx not in (None, "sum", "mean", "max", "min", "cat"):
            raise ValueError("`dist_reduce_fx` must be one of ['mean', 'sum', 'cat', 'min', 'max', None]")
        if name in ("update", "compute", "forward", "reset"):
            raise ValueError(f"The name {name!r} clashes with a Metric method")
        self._defaults[name] = default
        self._persistent[name] = persistent
        self._reductions[name] = dist_reduce_fx
        if isinstance(default, list):
            setattr(self, name, [])
        else:
            # saved by _save_to_state_dict below, under this metric's rules
            self.register_buffer(name, default.clone(), persistent=False)

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
                self._inner_update(*args, **kwargs)
            return self._snapshot_state()

        return self._with_state(state, _run)

    def compute_state(self, state: Dict[str, Any]) -> Any:
        """Pure compute: ``state -> value``."""
        with torch.no_grad():
            return self._with_state(state, self._compute_impl)

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

    # ------------------------------------------------------------------
    # lifecycle: forward / update / compute / reset
    # ------------------------------------------------------------------
    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Accumulate the batch into the state and (optionally) return the batch value."""
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
            for name in self._defaults:
                setattr(self, name, self._default_value(name))
            self._update_count = 1
            self._computed = None
            self.update(*args, **kwargs)
            batch_val = self.compute()
        finally:
            self._restore_state(cache)
            self._update_count = update_count
            self._computed = computed
        return batch_val

    def _forward_reduce_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """Batch delta on fresh state, merged into the accumulated state."""
        global_state = self._snapshot_state()
        update_count = self._update_count
        try:
            for name in self._defaults:
                setattr(self, name, self._default_value(name))
            self.update(*args, **kwargs)
            batch_state = self._snapshot_state()
            batch_val = self.compute()
            merged = self.merge_states(global_state, batch_state)
        except BaseException:
            # keep the prior accumulation when the batch update or compute raised
            self._restore_state(global_state)
            self._update_count = update_count
            raise
        self._restore_state(merged)
        self._update_count = update_count + 1
        self._computed = None
        return batch_val

    def _wrap_update(self, update: Callable) -> Callable:
        @functools.wraps(update)
        def wrapped_func(*args: Any, **kwargs: Any) -> None:
            self._computed = None
            self._update_count += 1
            with torch.no_grad():
                update(*args, **kwargs)

        self._inner_update = update
        return wrapped_func

    def _wrap_compute(self, compute: Callable) -> Callable:
        @functools.wraps(compute)
        def wrapped_func(*args: Any, **kwargs: Any) -> Any:
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
            with torch.no_grad():
                self._computed = _squeeze_if_scalar(compute(*args, **kwargs))
            return self._computed

        self._compute_impl = compute
        return wrapped_func

    def reset(self) -> None:
        """Reset states to their defaults."""
        self._update_count = 0
        self._forward_cache = None
        self._computed = None
        for name in self._defaults:
            setattr(self, name, self._default_value(name))

    def update(self, *_: Any, **__: Any) -> None:  # pragma: no cover - replaced in __init__
        """Override to update the metric state from a batch."""
        raise NotImplementedError

    def compute(self) -> Any:  # pragma: no cover - replaced in __init__
        """Override to compute the final value from the metric state."""
        raise NotImplementedError

    def _apply(self, fn: Callable, *args: Any, **kwargs: Any) -> "Metric":
        """``.to()``/``.cuda()``/``.cpu()`` move the defaults and list states
        with the buffers, so ``reset`` stays on the new device."""
        super()._apply(fn, *args, **kwargs)
        self._defaults = {n: (d if isinstance(d, list) else fn(d)) for n, d in self._defaults.items()}
        for name, d in self._defaults.items():
            if isinstance(d, list):
                setattr(self, name, [fn(x) for x in getattr(self, name)])
            else:
                self._device = d.device
        return self

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
        device, in its registered dtype); a persistent state that is absent
        is a missing key."""
        for name, default in self._defaults.items():
            key = prefix + name
            if key not in state_dict:
                if self._persistent[name]:
                    missing_keys.append(key)
                continue
            v = state_dict[key]
            if isinstance(default, list):
                setattr(self, name, [torch.as_tensor(x, device=self._device).clone() for x in v])
                continue
            t = torch.as_tensor(v, device=self._device)
            if t.shape != default.shape:
                error_msgs.append(f"state {key!r}: shape {tuple(t.shape)} in the checkpoint, {tuple(default.shape)} here")
            elif t.is_floating_point() != default.is_floating_point():
                error_msgs.append(f"state {key!r}: dtype {t.dtype} in the checkpoint, {default.dtype} here")
            else:
                setattr(self, name, t.to(default.dtype).clone())
        for attr in self._dynamic_state_attrs:
            if prefix + attr in state_dict:
                setattr(self, attr, _decode_dynamic(state_dict[prefix + attr]))
        known = set(self._defaults) | set(self._dynamic_state_attrs)
        for key in state_dict:
            if key.startswith(prefix) and key[len(prefix):] not in known and "." not in key[len(prefix):]:
                unexpected_keys.append(key)
        self._computed = None

    # ------------------------------------------------------------------
    # pickling / copying
    # ------------------------------------------------------------------
    def __getstate__(self) -> Dict[str, Any]:
        """The instance's attributes without the wrappers ``__init__`` made:
        they are closures over this instance (a copy would update the
        original) and do not pickle. State tensors pickle as they are, with
        their device: a CUDA state comes back on CUDA, and ``_device`` with
        it (the JAX package turns its states into numpy instead)."""
        skip = ("update", "compute", "_update_signature", "_inner_update", "_compute_impl")
        return {k: v for k, v in self.__dict__.items() if k not in skip}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        """Rebuild the wrappers from the class's own methods, as ``__init__``
        does, after unpickling or ``deepcopy``. The warn-once token is issued
        anew: a copy does not share the original's warning history, and a
        pickled token could collide with one issued in this process."""
        super().__setstate__(state)
        self._update_signature = inspect.signature(self.update)
        self.update = self._wrap_update(self.update)  # type: ignore[method-assign]
        self.compute = self._wrap_compute(self.compute)  # type: ignore[method-assign]
        self._warn_token = instance_token()

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

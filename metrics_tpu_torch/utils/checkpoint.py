"""Checkpoint and resume of metric states (counterpart of
``metrics_tpu/utils/checkpoint.py``).

* :func:`metric_state_pytree` / :func:`restore_metric_state_pytree`: a
  plain tree with numpy leaves, under the JAX package's keys
  (``_update_count``; ``_<name>_is_list`` with a list buffer as a dict keyed
  ``"0".."n-1"``; ``_dynamic``, the attributes learned during update, as
  JSON bytes in a ``uint8`` array; ``_health_screened``). A tree written by
  either package restores into the other.
* :func:`save_metric_state` / :func:`load_metric_state`: that tree, for a
  metric or a ``MetricCollection``, in a file written by ``torch.save`` and
  read by ``torch.load(..., weights_only=True)``, so loading a checkpoint
  cannot run code. The JAX package's orbax checkpoint directories are not
  read here.

A placed sharded metric (``shard_states``, ``drive(mesh=, in_specs=)``)
writes its global states, gathered over the mesh (a collective every
process of the mesh makes), and restores by its registered layout: each
process keeps its shard.
"""
import json
from typing import Any, Dict

import numpy as np
import torch

from metrics_tpu_torch.metric import Metric, _decode_dynamic, _encode_dynamic
from metrics_tpu_torch.resilience import health as _health
from metrics_tpu_torch.sharding import spec as _shard_spec

__all__ = [
    "dtype_kind",
    "load_metric_state",
    "metric_state_pytree",
    "restore_metric_state_pytree",
    "save_metric_state",
]


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def metric_state_pytree(metric: Metric) -> Dict[str, Any]:
    """Every registered state as numpy (a list buffer as a dict keyed by
    position), the update count, the learned attributes and the health
    screening count."""
    out: Dict[str, Any] = {"_update_count": metric._update_count}
    for name in metric._defaults:
        value = getattr(metric, name)
        layout = metric._shard_layout.get(name)
        if layout is not None:
            value = _shard_spec.gather_state(value, layout, metric._shard_mesh)
        if isinstance(value, list):
            out[name] = {str(i): _numpy(v) for i, v in enumerate(value)}
            out[f"_{name}_is_list"] = True
        else:
            out[name] = _numpy(value)
    if metric._dynamic_state_attrs:
        dyn = {a: _encode_dynamic(getattr(metric, a)) for a in metric._dynamic_state_attrs}
        out["_dynamic"] = np.frombuffer(json.dumps(dyn).encode("utf-8"), dtype=np.uint8)
    if _health.HEALTH_STATE in metric._defaults:
        out["_health_screened"] = np.asarray(metric._health_stats["batches_screened"])
    return out


def dtype_kind(dtype: Any) -> str:
    """The coarse family of a torch or numpy dtype (``float``, ``int``,
    ``bool``): widths may differ between a checkpoint and the metric, the
    family may not."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bool:
            return "bool"
        if dtype.is_complex:
            return "c"
        return "float" if dtype.is_floating_point else "int"
    kind = np.dtype(dtype).kind
    return {"f": "float", "V": "float", "i": "int", "u": "int", "b": "bool"}.get(kind, kind)


def restore_metric_state_pytree(metric: Metric, tree: Dict[str, Any]) -> Metric:
    """The inverse of :func:`metric_state_pytree`, in place, onto the
    metric's device. Every state is checked against its registration first
    (list or tensor, shape, dtype family) and the learned attributes
    decoded; only then is anything bound, so a restore that raises leaves
    the metric as it was. Absent or mis-shaped health counters restore as
    zeros."""
    cls = type(metric).__name__
    if "_update_count" not in tree:
        raise KeyError(f"Checkpoint tree for {cls} is missing '_update_count' — not a metric_state_pytree snapshot?")
    missing = [name for name in metric._defaults if name not in tree and name != _health.HEALTH_STATE]
    if missing:
        held = sorted(k for k in tree if not k.startswith("_"))
        raise KeyError(
            f"Checkpoint tree is missing state(s) {missing} registered by {cls}; the tree holds {held}."
            " Restoring it would silently drop state."
        )
    dev = metric.device
    restored: Dict[str, Any] = {}
    for name, default in metric._defaults.items():
        if name == _health.HEALTH_STATE and name not in tree:
            restored[name] = torch.zeros_like(default)
            continue
        value = tree[name]
        is_list_value = bool(tree.get(f"_{name}_is_list", False)) or isinstance(value, dict)
        if isinstance(default, list) != is_list_value:
            want, got = ("list buffer", "array") if isinstance(default, list) else ("array", "list buffer")
            raise ValueError(
                f"State {name!r} of {cls} is registered as a {want} but the checkpoint holds a {got}"
                " — wrong metric class or config?"
            )
        if is_list_value:
            items = sorted(value.items(), key=lambda kv: int(kv[0]))
            restored[name] = [torch.as_tensor(np.asarray(v), device=dev) for _, v in items]
            continue
        arr = np.asarray(value)
        if name == _health.HEALTH_STATE and tuple(arr.shape) != tuple(default.shape):
            restored[name] = torch.zeros_like(default)
            continue
        registered = _shard_spec.registered_shape(metric, name)
        if tuple(arr.shape) != tuple(registered):
            raise ValueError(
                f"State {name!r} of {cls} has registered default shape {tuple(registered)} but the checkpoint"
                f" holds shape {tuple(arr.shape)} — was it saved from a different configuration (e.g. another"
                " num_classes)?"
            )
        if dtype_kind(arr.dtype) != dtype_kind(default.dtype):
            raise ValueError(
                f"State {name!r} of {cls} is registered as {dtype_kind(default.dtype)} ({default.dtype}) but the"
                f" checkpoint holds {dtype_kind(arr.dtype)} ({arr.dtype})."
            )
        restored[name] = _shard_spec.local_value(metric, name, arr).to(default.dtype)
    restored_dyn: Dict[str, Any] = {}
    if "_dynamic" in tree:
        try:
            dyn = json.loads(bytes(np.asarray(tree["_dynamic"], np.uint8)).decode("utf-8"))
            restored_dyn = {attr: _decode_dynamic(value) for attr, value in dyn.items()}
        except (ValueError, UnicodeDecodeError, AttributeError, TypeError) as err:
            raise ValueError(f"Checkpoint tree for {cls} carries an unparseable '_dynamic' attribute blob: {err}") from err
    # everything validated: bind
    metric._update_count = int(np.asarray(tree["_update_count"]))
    if "_health_screened" in tree:
        metric._health_stats["batches_screened"] = int(np.asarray(tree["_health_screened"]))
    metric._restore_state(restored)
    if _health.HEALTH_STATE in restored:
        _health.reset_seen_mirrors(metric, restored[_health.HEALTH_STATE].cpu().numpy())
    for attr, value in restored_dyn.items():
        setattr(metric, attr, value)
    metric._computed = None
    metric._is_synced = False
    metric._cache = None
    _shard_spec.mark_global(metric)  # the tree holds the global states
    return metric


def _collection_tree(obj: Any) -> Dict[str, Any]:
    from metrics_tpu_torch.collections import MetricCollection

    if isinstance(obj, MetricCollection):
        return {name: metric_state_pytree(m) for name, m in obj.items()}
    return metric_state_pytree(obj)


def _restore_collection_tree(obj: Any, tree: Dict[str, Any]) -> Any:
    from metrics_tpu_torch.collections import MetricCollection

    if isinstance(obj, MetricCollection):
        for name, m in obj.items():
            restore_metric_state_pytree(m, tree[name])
        return obj
    return restore_metric_state_pytree(obj, tree)


def _map_leaves(tree: Any, fn: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    return fn(tree)


def save_metric_state(path: str, metric: Any) -> None:
    """Write the state tree of a metric or ``MetricCollection`` to ``path``
    (``torch.save``; the numpy leaves are stored as CPU tensors)."""
    tree = _map_leaves(_collection_tree(metric), lambda x: torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) else x)
    torch.save(tree, path)


def load_metric_state(path: str, metric: Any) -> Any:
    """Restore a file written by :func:`save_metric_state` into ``metric``
    (read with ``weights_only=True``); the states go to the metric's device."""
    tree = torch.load(path, map_location="cpu", weights_only=True)
    tree = _map_leaves(tree, lambda x: x.numpy() if isinstance(x, torch.Tensor) else x)
    return _restore_collection_tree(metric, tree)

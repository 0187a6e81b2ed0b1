"""Mesh-change resharding: re-lay a metric's split states onto another mesh
(counterpart of ``metrics_tpu/fleet/reshard.py``).

A worker that restarts on another topology (four devices instead of eight,
a ``(1, 4)`` mesh instead of ``(2, 2)``) changes the mesh under every
``add_state(sharding=PartitionSpec(...))`` state it hosts. The annotations
name mesh *axes*, not devices, so the same registration serves any mesh
that defines the axis.

:func:`reshard_onto` is the one supported move. For the annotated states it

1. validates each live value against :meth:`Metric.state_spec` (the dtype,
   and the shape of this process's shard of the registered global shape):
   resharding is never where a corrupted carry sneaks through;
2. re-lays them onto the new mesh by their registered specs
   (``sharding.spec.place_states``: a shard of the old mesh is gathered over
   its split axes and sliced to this process's shard of the new one, the
   defaults too, so ``reset()`` stays placed on the new mesh);
3. re-binds the whole tree through :meth:`Metric.bind_state`, which checks
   the placed values once more and drops the compute cache.

The port runs one process per device, and a placed state is this process's
shard, so the move is a collective: every process of both meshes calls
:func:`reshard_onto` (the JAX package's is one controller's
``jax.device_put``). The round trip is bit-exact, since re-laying moves
bytes and computes nothing; ``verify=True`` checks that on the *global*
states, gathered before and after (a collective too). Telemetry rides the
existing surfaces: the moved leaves are a ``reshard`` bus event, and each
call adds one to ``shard_stats()["mesh_changes"]``.
"""
from typing import Any, Dict

import numpy as np

from metrics_tpu_torch.sharding import spec as _spec
from metrics_tpu_torch.utils.exceptions import MetricsUserError

__all__ = ["reshard_onto"]


def _global_states(metric: Any) -> Dict[str, np.ndarray]:
    """Every annotated state's global value on the host: each placed shard
    gathered over its split axes (a collective every process makes)."""
    layouts = metric.__dict__.get("_shard_layout") or {}
    out = {}
    for name in metric._state_shardings:
        value = getattr(metric, name)
        layout = layouts.get(name)
        if layout is not None and layout.splits:
            value = _spec.gather_state(value, layout, metric._shard_mesh)
        out[name] = value.detach().cpu().numpy()
    return out


def reshard_onto(metric: Any, mesh: Any, verify: bool = False) -> Any:
    """Re-lay ``metric``'s annotated states onto ``mesh`` (see the module
    docstring); every process of the old and the new mesh calls it.

    ``verify=True`` gathers every annotated state before and after and
    raises ``MetricsUserError`` on any bit difference: the move must be a
    pure layout change. Returns ``metric``, bound to the new mesh, so
    ``reset()`` places fresh defaults on it."""
    shardings = metric.__dict__.get("_state_shardings") or {}
    if not shardings:
        raise MetricsUserError(
            f"reshard_onto: {type(metric).__name__} registers no"
            " add_state(sharding=) annotations — nothing to re-lay. Use"
            " shard_states(mesh) for first placement of annotated metrics."
        )
    spec_by_name = metric.state_spec()
    layouts = metric.__dict__.get("_shard_layout") or {}
    cls = type(metric).__name__
    state = metric._snapshot_state()
    for name in shardings:
        expected = spec_by_name[name]
        layout = layouts.get(name)
        shape = layout.local_shape if layout is not None else tuple(expected.shape)
        live = state[name]
        if tuple(live.shape) != tuple(shape) or live.dtype != expected.dtype:
            raise MetricsUserError(
                f"reshard_onto: state {cls}.{name} is"
                f" {live.dtype}{tuple(live.shape)} but state_spec() promises"
                f" {expected.dtype}{tuple(shape)} — refusing to"
                " re-lay a carry that no longer matches its registration."
            )
    before = _global_states(metric) if verify else None
    _spec.place_states(metric, mesh, source=f"fleet.reshard:{cls}", count_change=False)
    # bind_state re-validates the placed tree and resets the compute cache:
    # a resharded metric must not serve a value cached from the old layout
    metric.bind_state(metric._snapshot_state(), update_count=metric._update_count)
    _spec.count_mesh_change()
    if before is not None:
        after = _global_states(metric)
        for name, old in before.items():
            if not np.array_equal(old, after[name], equal_nan=True):
                raise MetricsUserError(
                    f"reshard_onto: state {cls}.{name} changed bits across the"
                    " mesh move — resharding must be bit-exact."
                )
    return metric

"""Sharded-epoch plumbing for ``engine.drive(mesh=, in_specs=)``
(counterpart of ``metrics_tpu/sharding/reduce.py``).

The JAX package runs this mode as one GSPMD program: the batch axis of each
input is split over the data axis and the partitioner keeps every sharded
state resident as shards, inserting the data-axis partial sums itself. The
port runs one process per device, so the same epoch is written out by
hand: every process is given the whole stacked epoch (the SPMD contract),
:func:`stage_epoch_inputs` takes this process's slice of each input by its
``in_specs``, each process's programs update the local shards of its states
with that slice (the class-windowed kernels count only its rows), and the
drive's sync sums the partial states over the data axes.
"""
from typing import Any, Dict, List, Sequence, Tuple

import torch

from metrics_tpu_torch.parallel.comm import mesh_spans_processes  # noqa: F401
from metrics_tpu_torch.sharding import spec as _spec
from metrics_tpu_torch.sharding.spec import PartitionSpec

__all__ = [
    "build_constraints",
    "constrain_state_tree",
    "mesh_spans_processes",
    "normalize_in_specs",
    "stage_epoch_inputs",
    "state_shardings_key",
]


def normalize_in_specs(in_specs: Any, n_args: int) -> Tuple[PartitionSpec, ...]:
    """``drive(in_specs=)`` as one spec per stacked update argument (a single
    spec applies to all). Each describes the stacked ``[steps, batch, ...]``
    layout; the steps axis (dim 0) stays whole, since the programs consume
    steps in order (the ``axis_name=`` mode splits steps)."""
    if isinstance(in_specs, (PartitionSpec, str)):
        in_specs = (in_specs,) * n_args
    specs = []
    for i, entry in enumerate(tuple(in_specs)):
        if isinstance(entry, str):
            entry = PartitionSpec(entry)
        if entry is None:
            entry = PartitionSpec()
        if not isinstance(entry, PartitionSpec):
            raise ValueError(
                f"drive(in_specs=...): entry {i} must be a PartitionSpec (or"
                f" None for replicated), got {entry!r}"
            )
        if len(entry) > 0 and entry[0] is not None:
            raise ValueError(
                f"drive(in_specs=...): entry {i} shards the leading STEPS axis"
                f" ({entry}); shard the batch axis (e.g. PartitionSpec(None,"
                " 'dp')) — the programs consume steps in order. For"
                " step-sharded epochs use drive(axis_name=, mesh=)."
            )
        specs.append(entry)
    if len(specs) != n_args:
        raise ValueError(
            f"drive(in_specs=...) has {len(specs)} specs for {n_args} stacked"
            " update arguments; pass one spec per argument (or a single spec"
            " to broadcast)."
        )
    return tuple(specs)


def input_axes(in_specs: Sequence[PartitionSpec]) -> Tuple[str, ...]:
    """The mesh axes the inputs are split over: the data axes the drive's
    sync reduces over."""
    out: List[str] = []
    for spec in in_specs:
        for entry in spec:
            for axis in () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry)):
                if axis not in out:
                    out.append(axis)
    return tuple(out)


def stage_epoch_inputs(mesh: Any, in_specs: Sequence[PartitionSpec], leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """This process's slice of each stacked leaf by its spec (a view: the
    steps stay whole, the batch rows are this process's chunk in
    ``torch.chunk`` order)."""
    staged = []
    for leaf, spec in zip(leaves, in_specs):
        layout = _spec.layout_of(mesh, spec, tuple(leaf.shape), "in_specs")
        out = leaf
        for dim, _ in layout.splits:
            out = out.narrow(dim, layout.offsets[dim], layout.local_shape[dim])
        staged.append(out)
    return staged


def state_shardings_key(keys: Sequence[str], members: Sequence[Any]) -> Tuple:
    """Hashable per-member state-sharding summary for the driver's program
    key: ``((member_key, ((state, canonical_spec), ...)), ...)``; members
    without annotations add nothing."""
    out = []
    for key, member in zip(keys, members):
        shardings = member.__dict__.get("_state_shardings")
        if not shardings:
            continue
        entries = tuple(sorted((name, _spec.canonical_spec(s)) for name, s in shardings.items()))
        if entries:
            out.append((key, entries))
    return tuple(out)


def build_constraints(keys: Sequence[str], members: Sequence[Any], mesh: Any) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """Member key -> state name -> the local-shard shape each placed state
    must keep through the programs (the port's counterpart of the
    ``NamedSharding`` constraints of the JAX scan carry)."""
    out: Dict[str, Dict[str, Tuple[int, ...]]] = {}
    for key, member in zip(keys, members):
        layouts = member.__dict__.get("_shard_layout") or {}
        if layouts and member.__dict__.get("_shard_mesh") is mesh:
            out[key] = {name: layout.local_shape for name, layout in layouts.items()}
    return out


def constrain_state_tree(
    states: Dict[str, Dict[str, Any]], constraints: Dict[str, Dict[str, Tuple[int, ...]]]
) -> Dict[str, Dict[str, Any]]:
    """Hold every placed state to its local-shard shape: a member whose
    update gave a state of another shape (a global value where its shard
    belongs) raises here, naming ``member.state``, instead of carrying the
    wrong layout on."""
    for key, member_shapes in constraints.items():
        state = states.get(key) or {}
        for name, shape in member_shapes.items():
            value = state.get(name)
            if isinstance(value, torch.Tensor) and tuple(value.shape) != tuple(shape):
                raise ValueError(
                    f"state {key}.{name} left the program with shape {tuple(value.shape)}; its shard is {tuple(shape)}"
                )
    return states

"""The encoder runtime (counterpart of ``metrics_tpu/encoders/runtime.py``).

:class:`ShardedEncoder` turns a "callable returning ``[N, d]`` features"
into a program of the shared engine cache (``engine/cache.py``, entry kind
``encode``):

* **One program per input signature.** On the card each signature is one
  CUDA graph, captured once and replayed; on the CPU the forward runs
  eagerly under the in-program flag. Every encoder object with the same
  ``(apply_fn, parameter signature, specs, mesh)`` shares one program
  family: the parameter values are runtime data, copied into the graph's
  static buffers at each replay, as metric states are.
* **Weights placed once.** ``param_specs`` annotates each parameter leaf
  with a :class:`~metrics_tpu_torch.sharding.PartitionSpec`, validated by
  the rules of ``add_state(sharding=)`` (``sharding/spec.py``).
  :meth:`ShardedEncoder.place` lays the weights out over a ``DeviceMesh``
  (one process per device): each process keeps its shard of a split leaf,
  a plain tensor, its layout recorded, as placed metric states are.
* **Gathered inside the dispatch.** Torch has no partitioner for an
  arbitrary ``apply_fn``, so each dispatch all-gathers the split leaves
  over their mesh axes and runs ``apply_fn`` on the whole weights and this
  process's rows. On NCCL the gather is a functional collective inside the
  program (the CUDA graph holds it); on gloo, which a graph cannot hold,
  the weights are gathered just before the dispatch and copied into the
  program's static buffers. ``compile_stats()["param_gather"]`` says which.
  One gather of the weights per dispatch moves far fewer bytes than
  splitting a convolution network's activations at every layer would.
* **Rows staged over the data axes.** ``in_specs`` splits each input's
  batch axis over the named mesh axes (``torch.chunk`` order, so a batch
  the axes do not divide splits unevenly and each row is encoded once).
  ``out_spec`` gives the block of the features a call returns: a named
  feature axis keeps this process's slice of it. Rows an input spec split
  stay split whatever ``out_spec`` says of dimension 0: the port's states
  are partial over the data axes and summed at ``compute()``.
* **Fused encode and accumulate.** :meth:`ShardedEncoder.encode_into` runs
  the forward and a ``consumer(carry, features, valid)`` in one program,
  so a chunk's features never leave it (the streaming driver,
  ``encoders/stream.py``). The consumer gets this process's rows at full
  width, and a feature-split state keeps its own window of them (FID's
  moments), where the JAX package pins the layout with ``out_spec``.

Telemetry: :func:`encoder_stats` counts placements, encode and fused
dispatches, streamed chunks and rows, screened rows, quarantined batches
and pow2-bucketed dispatches, and keeps each placed encoder's resident
parameter bytes (``params_bytes_total``, ``params_bytes_per_device``,
``devices``, ``placements``) under its name.
"""
import hashlib
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from metrics_tpu_torch.engine import _tree
from metrics_tpu_torch.sharding import spec as _shard_spec
from metrics_tpu_torch.sharding.spec import PartitionSpec, ShardLayout

__all__ = ["ShardedEncoder", "count_bucketed_dispatch", "encoder_stats", "reset_encoder_stats"]

_STATS_LOCK = threading.Lock()


def _new_stats() -> Dict[str, Any]:
    return {
        # place(mesh) calls: one layout of the weights over a mesh each
        "placements": 0,
        # plain encode dispatches (encoder(*inputs))
        "encode_calls": 0,
        # fused encode+accumulate dispatches (stream.encode_stream chunks)
        "fused_calls": 0,
        # streamed chunks and the real (non-pad) rows they carried
        "stream_chunks": 0,
        "rows_encoded": 0,
        # health screening upstream of the encoder (stream driver)
        "rows_screened": 0,
        "batches_quarantined": 0,
        # dispatches whose batch axis was padded to a pow2 bucket
        "bucketed_dispatches": 0,
        # per-encoder weight residency by name (filled by place(mesh)):
        # {params_bytes_total, params_bytes_per_device, devices, placements}
        "encoders": {},
    }


_STATS = _new_stats()


def encoder_stats() -> Dict[str, Any]:
    """Process-wide encoder telemetry (see module docstring)."""
    with _STATS_LOCK:
        out = dict(_STATS)
        out["encoders"] = {k: dict(v) for k, v in _STATS["encoders"].items()}
    return out


def reset_encoder_stats() -> None:
    with _STATS_LOCK:
        _STATS.clear()
        _STATS.update(_new_stats())


def count(key: str, n: int = 1) -> None:
    with _STATS_LOCK:
        _STATS[key] += n


def count_bucketed_dispatch() -> None:
    """One pow2-bucketed encoder launch (rows padded or the token axis
    trimmed): `encode_stream`'s chunks and BERTScore's chunked corpus pass."""
    count("bucketed_dispatches")


def _record_encoder(name: str, total: int, per_device: int, devices: int) -> None:
    with _STATS_LOCK:
        rec = _STATS["encoders"].setdefault(
            name, {"params_bytes_total": 0, "params_bytes_per_device": 0, "devices": 1, "placements": 0}
        )
        rec["params_bytes_total"] = int(total)
        rec["params_bytes_per_device"] = int(per_device)
        rec["devices"] = int(devices)
        rec["placements"] += 1
        _STATS["placements"] += 1


# ---------------------------------------------------------------------------
# spec normalization (the state plane's rules)
# ---------------------------------------------------------------------------
def _is_spec_leaf(x: Any) -> bool:
    return x is None or isinstance(x, (PartitionSpec, str))


def _spec_leaves(tree: Any) -> List[Any]:
    """The leaves of a ``param_specs`` tree: a :class:`PartitionSpec`, an
    axis name or None is a leaf, whatever it is made of."""
    if _is_spec_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _spec_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _spec_leaves(v)]
    return [tree]


def _param_paths(params: Any) -> Tuple[List[str], List[Any], Any]:
    """``(paths, leaves, structure)`` of a parameter tree; a path is spelled
    as ``jax.tree_util.keystr`` spells it (``['block']['kernel']``, ``[0]``)."""
    leaves, structure = _tree.flatten(params)
    paths: List[str] = []

    def _walk(node: Any, prefix: str) -> None:
        if isinstance(node, tuple) and not hasattr(node, "_fields"):
            for i, x in enumerate(node):
                _walk(x, f"{prefix}[{i}]")
        elif isinstance(node, list):
            for i, x in enumerate(node):
                _walk(x, f"{prefix}[{i}]")
        elif isinstance(node, dict):
            for k, x in node.items():
                _walk(x, f"{prefix}[{k!r}]")
        else:
            paths.append(prefix or str(len(paths)))

    _walk(params, "")
    return paths, leaves, structure


def _normalize_one_spec(path: str, spec: Any, leaf: Any) -> Optional[PartitionSpec]:
    if spec is None:
        return None
    # the leaf's rank is all the validation reads: a zero-size stand-in of that rank
    probe = torch.empty((0,) * (leaf.ndim if isinstance(leaf, torch.Tensor) else 0))
    return _shard_spec.normalize_state_sharding(path, spec, probe)


def _normalize_param_specs(param_specs: Any, params: Any) -> List[Optional[PartitionSpec]]:
    """One validated spec (or None) per parameter leaf. ``param_specs`` is
    None (nothing split), a callable ``(path, leaf) -> spec or None``, or a
    tree matching ``params`` whose leaves are specs, axis names or None (a
    single spec broadcasts to every leaf)."""
    paths, leaves, _ = _param_paths(params)
    if param_specs is None:
        return [None] * len(leaves)
    if callable(param_specs) and not _is_spec_leaf(param_specs):
        return [_normalize_one_spec(path, param_specs(path, leaf), leaf) for path, leaf in zip(paths, leaves)]
    spec_leaves = _spec_leaves(param_specs)
    if len(spec_leaves) == 1 and len(leaves) != 1:
        spec_leaves = spec_leaves * len(leaves)
    if len(spec_leaves) != len(leaves):
        raise ValueError(
            f"param_specs has {len(spec_leaves)} entries for {len(leaves)} parameter"
            " leaves; pass a matching pytree, a single spec to broadcast, or a"
            " callable (path, leaf) -> spec."
        )
    return [_normalize_one_spec(path, spec, leaf) for path, spec, leaf in zip(paths, spec_leaves, leaves)]


def _normalize_in_specs(in_specs: Any) -> Optional[Tuple[Any, ...]]:
    """None (no staging) or a tuple of per-input specs; a single spec or axis
    name broadcasts to every input (kept as ``("*", spec)``). A spec splits
    an input's batch axis (dimension 0) only: the port keeps the other
    dimensions whole."""
    if in_specs is None:
        return None
    broadcast = isinstance(in_specs, (PartitionSpec, str))
    entries = (in_specs,) if broadcast else tuple(in_specs)
    out: List[Optional[PartitionSpec]] = []
    for i, entry in enumerate(entries):
        if isinstance(entry, str):
            entry = PartitionSpec(entry)
        if entry is not None and not isinstance(entry, PartitionSpec):
            raise ValueError(f"in_specs entry {i} must be a PartitionSpec, mesh-axis name or None, got {entry!r}")
        if entry is not None and any(e is not None for e in tuple(entry)[1:]):
            raise ValueError(
                f"in_specs entry {i} ({entry}) splits an input past its batch axis; the port stages the"
                " batch axis (dimension 0) over the mesh and keeps the other dimensions whole"
            )
        out.append(entry)
    return ("*", out[0]) if broadcast else tuple(out)


def _canon(spec: Optional[PartitionSpec]) -> Tuple:
    return _shard_spec.canonical_spec(spec)


def _axes(entry: Any) -> Tuple[str, ...]:
    return () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))


# ---------------------------------------------------------------------------
# the runtime
# ---------------------------------------------------------------------------
class ShardedEncoder:
    """An encoder program: ``(params, *inputs) -> features``, its weights
    optionally laid out over a device mesh.

    Args:
        apply_fn: forward ``apply_fn(params, *inputs) -> features`` (for
            instance ``lambda p, x: inception_v3(p, x)["2048"]``). It runs
            inside a captured program on the card, so it must not wait for
            the device (no ``.item()``, no data-sized outputs).
        params: parameter tree (dicts, lists and tuples of tensors). Passed
            to every dispatch as runtime data, so encoders sharing
            ``apply_fn``, the parameter signature, the specs and the mesh
            share one program family.
        param_specs: per-leaf layout: None (nothing split), a tree matching
            ``params`` of ``PartitionSpec``/axis-name/None leaves (one spec
            broadcasts), or a callable ``(path, leaf) -> spec``. Validated by
            the rules of ``add_state(sharding=)``.
        mesh: a ``torch.distributed.device_mesh.DeviceMesh`` with named
            dims (one process per device) to place the weights on now
            (:meth:`place`).
        in_specs: one spec per input (a single spec broadcasts), e.g.
            ``PartitionSpec("dp")``: each process encodes its chunk of the
            batch axis over those axes, given the whole batch.
        out_spec: the block of the features a call returns, e.g.
            ``PartitionSpec(None, "mp")`` for this process's slice of the
            feature axis.
        name: telemetry label; defaults to ``apply_fn``'s name.
        device: where inputs are staged; defaults to the parameters'
            device, else ``apply_fn``'s ``device`` attribute, else the card.

    The instance is callable: ``encoder(*inputs)`` dispatches one forward.
    Placed, every dispatch is a collective: every process of the mesh makes
    it, in the same order.
    """

    _is_sharded_encoder = True

    def __init__(
        self,
        apply_fn: Callable,
        params: Any,
        *,
        param_specs: Any = None,
        mesh: Optional[Any] = None,
        in_specs: Any = None,
        out_spec: Any = None,
        name: Optional[str] = None,
        device: Optional[Any] = None,
    ) -> None:
        if not callable(apply_fn):
            raise TypeError(f"apply_fn must be callable, got {type(apply_fn).__name__}")
        self._apply = apply_fn
        self.name = name or getattr(apply_fn, "__name__", None) or type(apply_fn).__name__
        self.params = params
        self._param_specs = _normalize_param_specs(param_specs, params)
        self.in_specs = _normalize_in_specs(in_specs)
        if isinstance(out_spec, str):
            out_spec = PartitionSpec(out_spec)
        if out_spec is not None and not isinstance(out_spec, PartitionSpec):
            raise ValueError(f"out_spec must be a PartitionSpec, mesh-axis name or None, got {out_spec!r}")
        self.out_spec = out_spec
        self.mesh: Optional[Any] = None
        # per leaf: its ShardLayout on the mesh, or None (whole on every process)
        self._param_layouts: Tuple[Optional[ShardLayout], ...] = ()
        self.device = self._resolve_device(device)
        if mesh is not None:
            self.place(mesh)

    def _resolve_device(self, device: Optional[Any]) -> torch.device:
        from metrics_tpu_torch.metric import resolve_device

        if device is None:
            leaves, _ = _tree.flatten(self.params)
            device = next((x.device for x in leaves if isinstance(x, torch.Tensor)), None)
        if device is None:
            device = getattr(self._apply, "device", None)
        return resolve_device(device)

    # -- construction helpers ------------------------------------------
    @classmethod
    def from_callable(
        cls,
        fn: Callable,
        *,
        mesh: Optional[Any] = None,
        in_specs: Any = None,
        out_spec: Any = None,
        name: Optional[str] = None,
        device: Optional[Any] = None,
    ) -> "ShardedEncoder":
        """Wrap a plain ``(*inputs) -> features`` callable (weights hidden in
        the closure, so none are split: the program reads them by address;
        input staging and the output block still apply)."""

        def _apply(params: Any, *inputs: Any) -> Any:
            del params
            return fn(*inputs)

        _apply.__name__ = name or getattr(fn, "__name__", None) or type(fn).__name__
        if device is None:
            device = getattr(fn, "device", None)
        return cls(_apply, (), mesh=mesh, in_specs=in_specs, out_spec=out_spec, name=_apply.__name__, device=device)

    # -- identity -------------------------------------------------------
    def _param_signature(self) -> Tuple:
        """The parameter tree's structure and each leaf's shape, dtype and device."""
        leaves, structure = _tree.flatten(self.params)
        return structure, tuple(
            (tuple(leaf.shape), str(leaf.dtype), str(leaf.device)) if isinstance(leaf, torch.Tensor) else repr(leaf)
            for leaf in leaves
        )

    def _spec_key(self) -> Tuple:
        return (
            tuple(_canon(s) for s in self._param_specs),
            () if self.in_specs is None else tuple(e if isinstance(e, str) else _canon(e) for e in self.in_specs),
            _canon(self.out_spec),
        )

    def _program_key(self) -> Tuple[Tuple, Tuple]:
        """``(key, pins)`` for the shared cache: the apply callable (by
        identity, and pinned), the parameter signature, the canonical specs
        and the mesh (by identity, and pinned). Parameter values are runtime
        data and do not key: two encoders differing only in weights share
        one program."""
        cached = self.__dict__.get("_engine_key")
        if cached is not None:
            return cached, self.__dict__.get("_engine_key_pins", ())
        key = (id(self._apply), self._param_signature(), *self._spec_key(), None if self.mesh is None else id(self.mesh))
        pins: Tuple = (self._apply,) + (() if self.mesh is None else (self.mesh,))
        self._engine_key = key
        self._engine_key_pins = pins
        return key, pins

    def stable_digest(self) -> str:
        """A process-stable identity: the apply callable's qualified name,
        the parameter signature and the canonical specs (the serializable
        twin of the program key; object identities degrade to names)."""
        apply_name = getattr(self._apply, "__qualname__", None) or getattr(
            self._apply, "__name__", type(self._apply).__name__
        )
        payload = ("encode", apply_name, self._param_signature(), *self._spec_key())
        return hashlib.sha1(repr(payload).encode()).hexdigest()

    # -- placement ------------------------------------------------------
    def place(self, mesh: Any) -> "ShardedEncoder":
        """Lay the weights out over ``mesh``: each process keeps its shard of
        every split leaf (``torch.chunk`` order over the named axis) and
        the whole of the others. Placed on another mesh before, the old
        layout is gathered first (a collective over the old mesh), and the
        program key is made anew: a new mesh is a new program family."""
        paths, leaves, structure = _param_paths(self.params)
        old_mesh, old_layouts = self.mesh, self._param_layouts
        placed: List[Any] = []
        layouts: List[Optional[ShardLayout]] = []
        total = per_device = 0
        for i, (path, leaf, spec) in enumerate(zip(paths, leaves, self._param_specs)):
            old = old_layouts[i] if old_layouts else None
            if not isinstance(leaf, torch.Tensor):
                placed.append(leaf)
                layouts.append(None)
                continue
            shape = old.global_shape if old is not None else tuple(leaf.shape)
            layout = _shard_spec.layout_of(mesh, spec, shape, path) if spec is not None else None
            if layout is not None and not layout.splits:
                layout = None
            if not (old_mesh is mesh and old == layout):
                if old is not None:
                    leaf = _shard_spec.gather_state(leaf, old, old_mesh)
                if layout is not None:
                    leaf = _shard_spec.local_slice(leaf, layout)
            placed.append(leaf)
            layouts.append(layout)
            total += leaf.element_size() * int(torch.Size(shape).numel())
            per_device += leaf.numel() * leaf.element_size()
        self.params = _tree.unflatten(structure, placed)
        self._param_layouts = tuple(layouts)
        self.mesh = mesh
        self.__dict__.pop("_engine_key", None)
        self.__dict__.pop("_engine_key_pins", None)
        _record_encoder(self.name, total, per_device, int(mesh.size()))
        return self

    def params_nbytes(self) -> int:
        """Bytes of the parameters this process holds (its shards, placed)."""
        leaves, _ = _tree.flatten(self.params)
        return int(sum(x.numel() * x.element_size() for x in leaves if isinstance(x, torch.Tensor)))

    def _gathers_in_program(self) -> bool:
        """Whether the dispatch gathers the split leaves inside the program
        (every split axis on NCCL, whose collectives a graph captures)."""
        from metrics_tpu_torch.parallel import comm

        axes = {axis for layout in self._param_layouts if layout is not None for _, axis in layout.splits}
        return all(comm._in_program_backend(self.mesh.get_group(a)) for a in axes)

    def _gather(self, params: Any, in_program: bool) -> Any:
        leaves, structure = _tree.flatten(params)
        whole = [
            _shard_spec.gather_state(x, layout, self.mesh, in_program=in_program) if layout is not None else x
            for x, layout in zip(leaves, self._param_layouts)
        ]
        return _tree.unflatten(structure, whole)

    def _dispatch_params(self) -> Any:
        """What a dispatch passes as ``params``: the local shards where the
        program gathers them, else the whole weights gathered now."""
        if self.mesh is None or not any(self._param_layouts) or self._gathers_in_program():
            return self.params
        return self._gather(self.params, in_program=False)

    # -- rows -----------------------------------------------------------
    def _input_specs(self, n_inputs: int) -> Tuple[Optional[PartitionSpec], ...]:
        specs = self.in_specs or ()
        if specs and specs[0] == "*":
            return (specs[1],) * n_inputs
        return tuple(specs[i] if i < len(specs) else None for i in range(n_inputs))

    def _batch_axes(self) -> Tuple[str, ...]:
        """The mesh axes the inputs' batch axis is split over (the widest
        input spec's), or () when nothing is staged."""
        if self.mesh is None or self.in_specs is None:
            return ()
        from metrics_tpu_torch.parallel import comm

        best: Tuple[str, ...] = ()
        specs = self.in_specs[1:] if self.in_specs[0] == "*" else self.in_specs
        for spec in specs:
            axes = _axes(spec[0]) if spec is not None and len(spec) else ()
            if comm.axis_world(self.mesh, axes) > comm.axis_world(self.mesh, best):
                best = axes
        return best

    def batch_multiple(self) -> int:
        """The row multiple a staged batch divides into evenly: the product
        of the mesh-axis sizes ``in_specs`` splits the batch axis over (1
        unplaced or unstaged). Drivers round their pow2 row buckets up to it."""
        from metrics_tpu_torch.parallel import comm

        axes = self._batch_axes()
        return comm.axis_world(self.mesh, axes) if axes else 1

    def row_window(self, n: int) -> Optional[Tuple[int, int]]:
        """``(start, length)`` of the rows of an ``n``-row batch this
        process encodes (``torch.chunk`` order over the batch axes), or
        None when every process encodes all it is given."""
        axes = self._batch_axes()
        if not axes:
            return None
        from metrics_tpu_torch.parallel import comm

        return _shard_spec._chunk(int(n), comm.axis_world(self.mesh, axes), comm.axis_index(self.mesh, axes))

    def gather_rows(self, x: torch.Tensor, n: int, dim: int = 0) -> torch.Tensor:
        """The ``n`` rows of a batch along ``dim`` from every process's
        :meth:`row_window` of them: one all-gather over the batch axes, a
        collective every process of the mesh makes."""
        axes = self._batch_axes()
        if not axes:
            return x
        from metrics_tpu_torch.parallel import comm

        k = comm.axis_world(self.mesh, axes)
        size = -(-int(n) // k)
        dim = dim % x.ndim
        if x.shape[dim] < size:
            pad = list(x.shape)
            pad[dim] = size - x.shape[dim]
            x = torch.cat([x, x.new_zeros(pad)], dim=dim)
        parts = comm.reduce_in_trace(x, None, axes, mesh=self.mesh).unbind(0)
        return torch.cat(parts, dim=dim).narrow(dim, 0, int(n))

    def _stage_inputs(self, inputs: Tuple[Any, ...], valid: Optional[Any] = None) -> Tuple[Tuple[Any, ...], Any]:
        """This process's rows of each staged input (and of ``valid``)."""
        if not self._batch_axes():
            return inputs, valid
        staged = []
        for x, spec in zip(inputs, self._input_specs(len(inputs))):
            if spec is not None and len(spec) and spec[0] is not None:
                start, length = self.row_window(x.shape[0])
                x = x[start:start + length]
            staged.append(x)
        if valid is not None:
            start, length = self.row_window(valid.shape[0])
            valid = valid[start:start + length]
        return tuple(staged), valid

    def _out_block(self, out: Any) -> Any:
        """This process's block of the features by ``out_spec``: each named
        axis past the rows keeps its chunk; named rows are chunked where the
        inputs were not staged."""
        if self.mesh is None or self.out_spec is None or not isinstance(out, torch.Tensor):
            return out
        from metrics_tpu_torch.parallel import comm

        for dim, entry in enumerate(tuple(self.out_spec)):
            axes = _axes(entry)
            if not axes or (dim == 0 and self._batch_axes()):
                continue
            start, length = _shard_spec._chunk(
                int(out.shape[dim]), comm.axis_world(self.mesh, axes), comm.axis_index(self.mesh, axes)
            )
            out = out.narrow(dim, start, length)
        return out

    # -- dispatch -------------------------------------------------------
    def _traced_features(self, params: Any, inputs: Tuple[Any, ...]) -> Any:
        """The forward on this process's rows at full width: the split leaves
        gathered first where the program holds the gather."""
        if self.mesh is not None and any(self._param_layouts) and self._gathers_in_program():
            params = self._gather(params, in_program=True)
        return self._apply(params, *inputs)

    def _traced_apply(self, params: Any, inputs: Tuple[Any, ...]) -> Any:
        """The body the engine's ``encode`` entries run and capture."""
        return self._out_block(self._traced_features(params, inputs))

    def __call__(self, *inputs: Any) -> Any:
        """One forward through the shared engine cache."""
        from metrics_tpu_torch.engine import cache as _cache

        entry = _cache.encoder_entry(self)
        count("encode_calls")
        staged, _ = self._stage_inputs(inputs)
        return entry.invoke("encode", self, _cache.instance_stats(self), self._dispatch_params(), *staged)

    def encode(self, *inputs: Any) -> Any:
        return self(*inputs)

    def encode_into(self, consumer: Callable, carry: Any, inputs: Tuple[Any, ...], valid: Any) -> Any:
        """One fused encode+accumulate step: ``consumer(carry, features,
        valid) -> carry`` in the same program as the forward, the features
        this process's rows at full width. The entry is keyed by
        ``(encoder identity, consumer identity)``: pass a stable consumer
        object, or every call captures a new program."""
        from metrics_tpu_torch.engine import cache as _cache

        entry = _cache.encoder_entry(self, consumer=consumer)
        count("fused_calls")
        staged, valid = self._stage_inputs(tuple(inputs), valid)
        return entry.invoke("encode_acc", self, _cache.instance_stats(self), self._dispatch_params(), carry, valid, *staged)

    def compile_stats(self) -> Dict[str, Any]:
        """This encoder's share of the engine telemetry (the counters of
        ``Metric.compile_stats()``: captures on the card are ``compiles``);
        placed with split weights, ``param_gather`` says where the dispatch
        gathers them: ``"in_program"`` or ``"before_program"``."""
        from metrics_tpu_torch.engine import cache as _cache

        out: Dict[str, Any] = dict(_cache.instance_stats(self))
        if self.mesh is not None and any(self._param_layouts):
            out["param_gather"] = "in_program" if self._gathers_in_program() else "before_program"
        return out

    # -- lifecycle ------------------------------------------------------
    def __deepcopy__(self, memo: Dict) -> "ShardedEncoder":
        # an immutable inference program: metric clones share it (a copy
        # would fork the id-keyed program identity)
        return self

    def __getstate__(self) -> Dict[str, Any]:
        # the global weights, no mesh: a placed encoder's pickle gathers its
        # split leaves (a collective every process of the mesh makes), and
        # place(mesh) on the loaded copy lays them out again
        state = dict(self.__dict__)
        if self.mesh is not None and any(self._param_layouts):
            state["params"] = self._gather(self.params, in_program=False)
        state["mesh"] = None
        state["_param_layouts"] = ()
        for key in ("_engine_key", "_engine_key_pins", "_compile_stats"):
            state.pop(key, None)
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)

    def __repr__(self) -> str:
        sharded = sum(1 for s in self._param_specs if s is not None)
        return (
            f"ShardedEncoder(name={self.name!r}, params={len(self._param_specs)} leaves ({sharded} sharded),"
            f" device={self.device}, mesh={'bound' if self.mesh is not None else 'none'}, out_spec={self.out_spec})"
        )

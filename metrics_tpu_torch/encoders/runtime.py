"""The encoder runtime on one device (counterpart of
``metrics_tpu/encoders/runtime.py``).

:class:`ShardedEncoder` turns a "callable returning ``[N, d]`` features"
into a program of the shared engine cache (``engine/cache.py``, entry kind
``encode``):

* **One program per input signature.** On the card each signature is one
  CUDA graph, captured once and replayed; on the CPU the forward runs
  eagerly under the in-program flag. Every encoder object with the same
  ``(apply_fn, parameter signature)`` shares one program family: the
  parameter values are runtime data, copied into the graph's static
  buffers at each replay, as metric states are.
* **Fused encode and accumulate.** :meth:`ShardedEncoder.encode_into` runs
  the forward and a ``consumer(carry, features, valid)`` in one program,
  so a chunk's features never leave it (the streaming driver,
  ``encoders/stream.py``).

What the JAX runtime adds on a mesh (per-leaf ``PartitionSpec`` weights
placed once with ``place(mesh)``, ``in_specs`` batch staging, the
``out_spec`` activation constraint) is the encoder's mesh, ROADMAP §1
item 7b: those arguments raise here, and the ``placements`` counter stays 0.

Telemetry: :func:`encoder_stats` counts placements, encode and fused
dispatches, streamed chunks and rows, screened rows, quarantined batches
and pow2-bucketed dispatches.
"""
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from metrics_tpu_torch.engine import _tree
from metrics_tpu_torch.utils.exceptions import MetricsUserError

__all__ = ["ShardedEncoder", "count_bucketed_dispatch", "encoder_stats", "reset_encoder_stats"]

_STATS_LOCK = threading.Lock()


def _new_stats() -> Dict[str, Any]:
    return {
        # place(mesh) calls; 0 until the sharded state plane is ported
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
        # per-encoder weight residency by name (filled by place(mesh))
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


def _mesh_unported(what: str) -> MetricsUserError:
    return MetricsUserError(
        f"ShardedEncoder({what}) lays the encoder out over a device mesh, which is the encoder's mesh"
        " (ROADMAP §1 item 7b), not ported yet; the port's encoder runs on one device."
    )


class ShardedEncoder:
    """An encoder program: ``(params, *inputs) -> features``.

    Args:
        apply_fn: forward ``apply_fn(params, *inputs) -> features`` (for
            instance ``lambda p, x: inception_v3(p, x)["2048"]``). It runs
            inside a captured program on the card, so it must not wait for
            the device (no ``.item()``, no data-sized outputs).
        params: parameter tree (dicts, lists and tuples of tensors). Passed
            to every dispatch as runtime data, so encoders sharing
            ``apply_fn`` and the parameter signature share one program family.
        param_specs, mesh, in_specs, out_spec: the mesh layout of the JAX
            runtime; not ported (they raise unless None).
        name: telemetry label; defaults to ``apply_fn``'s name.
        device: where inputs are staged; defaults to the parameters'
            device, else ``apply_fn``'s ``device`` attribute, else the card.

    The instance is callable: ``encoder(*inputs)`` dispatches one forward.
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
        for what, value in (("param_specs=", param_specs), ("mesh=", mesh), ("in_specs=", in_specs), ("out_spec=", out_spec)):
            if value is not None:
                raise _mesh_unported(what)
        self._apply = apply_fn
        self.name = name or getattr(apply_fn, "__name__", None) or type(apply_fn).__name__
        self.params = params
        self.mesh = None
        self.in_specs = None
        self.out_spec = None
        self.device = self._resolve_device(device)

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
        the closure: the program reads them by address)."""

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
        leaves, spec = _tree.flatten(self.params)
        return spec, tuple(
            (tuple(leaf.shape), str(leaf.dtype), str(leaf.device)) if isinstance(leaf, torch.Tensor) else repr(leaf)
            for leaf in leaves
        )

    def _program_key(self) -> Tuple[Tuple, Tuple]:
        """``(key, pins)`` for the shared cache: the apply callable (by
        identity, and pinned) and the parameter signature. Parameter values
        are runtime data and do not key."""
        cached = self.__dict__.get("_engine_key")
        if cached is not None:
            return cached, self.__dict__.get("_engine_key_pins", ())
        key = (id(self._apply), self._param_signature())
        pins: Tuple = (self._apply,)
        self._engine_key = key
        self._engine_key_pins = pins
        return key, pins

    # -- placement ------------------------------------------------------
    def place(self, mesh: Any) -> "ShardedEncoder":
        raise _mesh_unported("place(mesh)")

    def params_nbytes(self) -> int:
        leaves, _ = _tree.flatten(self.params)
        return int(sum(x.numel() * x.element_size() for x in leaves if isinstance(x, torch.Tensor)))

    def batch_multiple(self) -> int:
        """The row multiple a staged batch must divide into: 1 on one device."""
        return 1

    # -- dispatch -------------------------------------------------------
    def _traced_apply(self, params: Any, inputs: Tuple[Any, ...]) -> Any:
        """The body the engine's ``encode`` entries run and capture."""
        return self._apply(params, *inputs)

    def __call__(self, *inputs: Any) -> Any:
        """One forward through the shared engine cache."""
        from metrics_tpu_torch.engine import cache as _cache

        entry = _cache.encoder_entry(self)
        count("encode_calls")
        return entry.invoke("encode", self, _cache.instance_stats(self), self.params, *inputs)

    def encode(self, *inputs: Any) -> Any:
        return self(*inputs)

    def encode_into(self, consumer: Callable, carry: Any, inputs: Tuple[Any, ...], valid: Any) -> Any:
        """One fused encode+accumulate step: ``consumer(carry, features,
        valid) -> carry`` in the same program as the forward. The entry is
        keyed by ``(encoder identity, consumer identity)``: pass a stable
        consumer object, or every call captures a new program."""
        from metrics_tpu_torch.engine import cache as _cache

        entry = _cache.encoder_entry(self, consumer=consumer)
        count("fused_calls")
        return entry.invoke("encode_acc", self, _cache.instance_stats(self), self.params, carry, valid, *inputs)

    def compile_stats(self) -> Dict[str, int]:
        """This encoder's share of the engine telemetry (the counters of
        ``Metric.compile_stats()``: captures on the card are ``compiles``)."""
        from metrics_tpu_torch.engine import cache as _cache

        return dict(_cache.instance_stats(self))

    # -- lifecycle ------------------------------------------------------
    def __deepcopy__(self, memo: Dict) -> "ShardedEncoder":
        # an immutable inference program: metric clones share it (a copy
        # would fork the id-keyed program identity)
        return self

    def __getstate__(self) -> Dict[str, Any]:
        state = dict(self.__dict__)
        for key in ("_engine_key", "_engine_key_pins", "_compile_stats"):
            state.pop(key, None)
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)

    def __repr__(self) -> str:
        leaves, _ = _tree.flatten(self.params)
        return f"ShardedEncoder(name={self.name!r}, params={len(leaves)} leaves, device={self.device}, mesh=none)"

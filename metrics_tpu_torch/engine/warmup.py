"""Warmup manifests: a worker's programs made at its start (counterpart of
``metrics_tpu/engine/warmup.py``).

A cold worker makes each program at the first request of its signature: on
the card an eager warm-up and a CUDA graph capture, the costliest request it
serves. This module records what a deployment serves and makes the whole set
when a worker starts.

* **Record.** :func:`record_manifest` turns on a process-wide recorder:
  every successful dispatch through the engine's shared cache (per-metric,
  fused collection, driver, bank and encoder programs) contributes its
  program signature: the entry kind, a process-stable config digest
  (:func:`stable_digest`), the variant, and every input (each tensor's
  shape, dtype and device, each other input by value, as the program key
  holds them). :func:`save_manifest` writes the de-duplicated set as
  versioned JSON, each entry with a compressed pickle of a reset template
  clone, so a later worker can rebuild the entry without the recording
  process's objects, and with the attributes the members learned in their
  first update (``meta["dyn"]``: ``Accuracy.mode``).

* **Warm.** :func:`warmup` reads a manifest, rebuilds each entry under the
  key a live dispatch computes (``metric_fingerprint``, ``fused_entry``,
  the driver's entry, ``bank_entry``, ``collection_bank_entry``,
  ``bank_drive_entry``, ``encoder_entry``), makes inputs of the recorded
  shapes, dtypes and devices (zeros; Python scalars by value) and runs
  ``SharedEntry.warm`` on them: where the JAX package compiles an
  executable ahead of time, the port *captures the graph* (on the CPU,
  where nothing is captured, it runs the key's first eager run). The live
  dispatch then finds the program: a warmed first request counts
  ``compiles == 0``. The probe stays: an instance's first dispatch still
  runs its Python body eagerly (``engine/cache.py``), so on the card a
  warmed first request is an eager run without a capture, and its later
  requests replay the graph.

* **Detect staleness.** Each warmed program leaves the explainer's
  signature of what the manifest promised. A new program key in a covered
  variant means the deployment drifted from the recording: a
  ``warmup_stale`` bus event names the changed component (``avals``,
  ``dtype``, ``structure``, ``bucket``, ``screening``), and
  :func:`warmup_report` (``obs.snapshot()["warmup"]``, the
  ``metrics_tpu_warmup_*`` families) counts it.

``METRICS_TPU_WARMUP_MANIFEST`` wires it with no code change
(:func:`_maybe_autowire_from_env`, called at the end of the package's
import): an existing manifest is warmed at import, a missing one is
recorded and saved at exit.

What differs from the JAX package, on purpose:

* **A warm is a capture**, kept in the engine's own program cache, not an
  executable in a side store.
* **A bank's graph holds the bank's addresses** (its ``Resident``), so
  ``bank_update``, ``collection_bank`` and ``bank_drive`` entries warm only
  on a live bank (:meth:`MetricBank.warmup` or ``templates=[bank]``); from
  a manifest's recipe they are skipped and counted
  (``skipped["bank_needs_live_bank"]``). The JAX bank warms from the recipe,
  since an executable holds no addresses. The port records collection
  banks too (kind ``collection_bank``), which the JAX package does not.
* **Templates unpickle under a restricted unpickler** that admits
  ``metrics_tpu_torch``, ``torch``, ``numpy`` and builtins only, with every
  tensor carried as raw bytes. A manifest recorded by the JAX package thus
  warms nothing here (its entries are skipped as ``no_template``) and never
  imports ``metrics_tpu`` or ``jax``: manifests do not cross packages, and
  their digests differ by the class path anyway.
* The document records ``torch_version`` where the JAX one records
  ``jax_version``.
* **Synthetic inputs, recorded attributes.** A capture on zeros takes the
  branches the recorded inputs took because a program decides on shapes,
  dtypes and configuration only: the program guard (``utils/program.py``)
  raises on every host read of a tensor's value. The warm clone also gets
  the attributes the manifest recorded before it runs, and a program after
  which they differ is refused and counted in ``programs_failed``.

Unrecordable, and counted (``recording.unrecordable``): mesh-bound programs
(a ``drive(mesh=)`` chunk, a pod bank's wave, a placed encoder), placed
metrics (``sharded_variant``), the fused encode+accumulate step (keyed by a
live consumer), and inputs no manifest can carry.
"""
import base64
import hashlib
import io
import json
import os
import pickle
import sys
import threading
import time
import zlib
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from metrics_tpu_torch.engine import _tree
from metrics_tpu_torch.engine import cache as _cache
from metrics_tpu_torch.obs import bus as _bus
from metrics_tpu_torch.obs import explain as _explain
from metrics_tpu_torch.obs.warn import warn_once as _warn_once
from metrics_tpu_torch.resilience import schema as _schema
from metrics_tpu_torch.utils.exceptions import SchemaVersionError

__all__ = [
    "ENV_VAR",
    "MANIFEST_VERSION",
    "WARMABLE_KINDS",
    "dispatch_key",
    "load_manifest",
    "manifest_dict",
    "record_manifest",
    "recording",
    "reset_warmup_state",
    "save_manifest",
    "stable_digest",
    "stop_recording",
    "warmup",
    "warmup_report",
]

ENV_VAR = "METRICS_TPU_WARMUP_MANIFEST"
#: v2 has v1's document shape; a v1 manifest upcasts with a warning, a newer
#: one raises ``SchemaVersionError`` from :func:`load_manifest`, which
#: :func:`warmup` turns into a warning and a cold start.
MANIFEST_VERSION = 2

#: Entry kinds a manifest covers: the JAX package's, and collection banks.
WARMABLE_KINDS = (
    "metric_update",
    "bank_update",
    "collection_bank",
    "bank_drive",
    "fused_update",
    "fused_forward",
    "fused_compute",
    "driver",
    "encode",
)
#: Kinds whose programs belong to a live bank's leaves.
_BANK_KINDS = ("bank_update", "collection_bank", "bank_drive")
_METRIC_KINDS = ("metric_update", "bank_update", "bank_drive")

#: An encoder's embedded pickle (its weights with it) is at most this large;
#: past it the manifest records its inputs only and needs a live template.
_ENCODER_TEMPLATE_MAX_BYTES = 16 << 20

_LOCK = threading.RLock()
_MAX_STALE_EVENTS = 32

_REC: Dict[str, Any] = {
    "recording": False,
    "path": None,
    "entries": {},  # (kind, digest) -> entry record
    "programs": 0,
    "unrecordable": {},  # reason -> count
}

# what warmup() loaded and what happened since; the seen_* sets keep
# repeated warmups of one manifest (one per bank) from inflating it
_WARM: Dict[str, Any] = {
    "loaded": False,
    "path": None,
    "manifest_entries": 0,
    "manifest_programs": 0,
    "entries_warmed": 0,
    "programs_warmed": 0,
    "programs_failed": 0,
    "skipped": {},
    "errors": [],
    "warmed_hits": 0,
    "stale_total": 0,
    "stale": [],
    "seen_entries": set(),
    "seen_programs": set(),
    "counted_warmed": set(),
}


class _Unrecordable(Exception):
    """A dispatch whose inputs cannot ride a JSON manifest."""


def _sync_hooks() -> None:
    """The engine watches dispatches while a manifest records or is loaded."""
    _cache.set_warm_hooks(_REC["recording"] or _WARM["loaded"])


# ---------------------------------------------------------------------------
# stable config digests
# ---------------------------------------------------------------------------
def _stable_token(value: Any) -> Tuple:
    """``cache._attr_token`` with object identities degraded to type names."""
    token = _cache._attr_token(value, [])
    if token[0] == "id":
        return ("obj", type(value).__name__)
    return token


def stable_digest(metric: Any) -> str:
    """A process-stable hex digest of one metric's program identity: class
    path, configuration, buffers and state spec, the serializable twin of
    ``engine.cache.metric_fingerprint``. The attributes an update learns
    count as they were when the instance was keyed (unset for a fresh
    one), so a served instance and a fresh template digest alike."""
    cls = type(metric)
    learned = metric.__dict__.get("_engine_key_dyn") or {}
    cfg = tuple(
        (name, _stable_token(learned[name] if name in learned else metric.__dict__[name]))
        for name in sorted(metric.__dict__)
        if not name.startswith("_") and name not in metric._defaults and name not in _cache._FP_SKIP
    )
    buffers = tuple(
        (name, _cache._digest(buf))
        for name, buf in sorted(metric._buffers.items())
        if name not in metric._defaults and buf is not None
    )
    state_spec: List[Tuple] = []
    for name, default in metric._defaults.items():
        fx = metric._reductions[name]
        fx_token = fx if (fx is None or isinstance(fx, str)) else ("obj", type(fx).__name__)
        if isinstance(default, list):
            state_spec.append((name, "list", fx_token))
        else:
            state_spec.append((name, _cache._digest(default), fx_token))
    payload = (f"{cls.__module__}.{cls.__qualname__}", cfg, buffers, tuple(state_spec))
    return hashlib.sha1(repr(payload).encode()).hexdigest()


def _entry_digest(kind: str, cell: Any, meta: Dict[str, Any]) -> str:
    """One entry's digest: the metric's for a one-metric kind, the encoder's
    for ``encode``, the member names and digests (and kind meta) otherwise."""
    if kind in _METRIC_KINDS:
        return stable_digest(cell)
    if kind == "encode":
        return cell.stable_digest()
    payload = (
        kind,
        tuple(meta.get("keys", ())),
        tuple(stable_digest(m) for m in cell),
        tuple(meta.get("compute_keys", ())),
        bool(meta.get("hierarchical", False)),
    )
    return hashlib.sha1(repr(payload).encode()).hexdigest()


# ---------------------------------------------------------------------------
# inputs to and from JSON
# ---------------------------------------------------------------------------
_PY_KINDS = {"int": int, "float": float, "bool": bool, "str": str}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _encode_obj(obj: Any) -> Any:
    """One dispatch input as JSON: a tensor by shape, dtype (numpy's name)
    and device; a Python scalar by value; containers recursively (a dict
    with its key order, which the program key holds)."""
    if obj is None:
        return {"n": 1}
    if isinstance(obj, bool):  # before int: bool is an int subclass
        return {"p": ["bool", obj]}
    if isinstance(obj, (int, float, str)):
        return {"p": [type(obj).__name__, obj]}
    if isinstance(obj, torch.Tensor):
        return {"a": [list(int(s) for s in obj.shape), _dtype_name(obj.dtype), False, str(obj.device)]}
    if isinstance(obj, tuple) and not hasattr(obj, "_fields"):
        return {"t": [_encode_obj(x) for x in obj]}
    if isinstance(obj, list):
        return {"l": [_encode_obj(x) for x in obj]}
    if isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            raise _Unrecordable("dict with non-string keys")
        return {"d": {k: _encode_obj(v) for k, v in obj.items()}, "k": list(obj)}
    raise _Unrecordable(f"argument of type {type(obj).__name__}")


def _decode_obj(spec: Dict[str, Any]) -> Any:
    """JSON -> the input a warm run gets: zeros of each recorded tensor's
    shape, dtype and device, scalars by value, the containers rebuilt."""
    if "n" in spec:
        return None
    if "p" in spec:
        kind, value = spec["p"]
        return _PY_KINDS[kind](value)
    if "a" in spec:
        shape, dtype, _weak = spec["a"][:3]
        device = spec["a"][3] if len(spec["a"]) > 3 else "cpu"
        return torch.zeros(tuple(shape), dtype=getattr(torch, dtype), device=device)
    if "t" in spec:
        return tuple(_decode_obj(x) for x in spec["t"])
    if "l" in spec:
        return [_decode_obj(x) for x in spec["l"]]
    if "d" in spec:
        return {k: _decode_obj(spec["d"][k]) for k in spec.get("k", spec["d"])}
    raise ValueError(f"unknown manifest argument spec {spec!r}")


def dispatch_key(fn_args: Tuple[Any, ...]) -> Tuple:
    """The part of a program key its inputs make: each tensor's shape, dtype
    and device, each other input by value, and their structure. A manifest's
    decoded inputs key exactly as the live inputs they stand for."""
    leaves, spec = _tree.flatten(tuple(fn_args))
    return _cache._program_key("", leaves, spec)[1:]


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------
def recording() -> bool:
    """Whether dispatches are being recorded."""
    return _REC["recording"]


def record_manifest(path: Optional[str] = None) -> None:
    """Record every engine dispatch's program signature from now on.
    ``path`` (or ``$METRICS_TPU_WARMUP_MANIFEST``) becomes
    :func:`save_manifest`'s default; recordings accumulate until
    :func:`reset_warmup_state`."""
    with _LOCK:
        _REC["recording"] = True
        if path or os.environ.get(ENV_VAR):
            _REC["path"] = path or os.environ.get(ENV_VAR)
    _sync_hooks()


def stop_recording() -> None:
    with _LOCK:
        _REC["recording"] = False
    _sync_hooks()


def _count(store: Dict[str, int], reason: str) -> None:
    store[reason] = store.get(reason, 0) + 1


def _unrecordable_reason(entry: Any, variant: str, cell: Any, resident: Any) -> Optional[str]:
    kind = entry.kind
    if variant.startswith("mesh_") or (resident is not None and resident.layout != ((), 1, 0)):
        return f"{kind}_mesh_bound"
    if kind == "encode" and cell.mesh is not None:
        return "encode_mesh_bound"
    if variant == "encode_acc":
        return "encoder_consumer_bound"
    if kind != "encode" and any(m.__dict__.get("_shard_layout") for m in _members(kind, cell)):
        return "sharded_variant"
    return None


def record_dispatch(
    entry: Any, variant: str, cell: Any, inputs: Tuple[Any, ...], bucket: Optional[int] = None, resident: Any = None
) -> None:
    """Record one successful dispatch (called by the engine while
    :func:`recording`), de-duplicated per entry and program key."""
    kind = entry.kind
    if kind not in WARMABLE_KINDS:
        return
    reason = _unrecordable_reason(entry, variant, cell, resident)
    if reason is not None:
        with _LOCK:
            _count(_REC["unrecordable"], reason)
        return
    try:
        prog_key = (variant, dispatch_key(inputs))
        hash(prog_key)
    except Exception:  # noqa: BLE001 — an unkeyable dispatch is unrecordable
        with _LOCK:
            _count(_REC["unrecordable"], "unkeyable_arguments")
        return
    meta = _entry_meta(entry, kind, cell)
    digest = entry.__dict__.get("_warm_digest")
    if digest is None:
        digest = entry._warm_digest = _entry_digest(kind, cell, meta)
    with _LOCK:
        rec = _REC["entries"].get((kind, digest))
        if rec is not None and prog_key in rec["seen"]:
            return
    try:
        specs = [_encode_obj(a) for a in inputs]
    except _Unrecordable as err:
        with _LOCK:
            _count(_REC["unrecordable"], str(err))
        return
    template = _template_payload(kind, cell) if rec is None else None
    with _LOCK:
        rec = _REC["entries"].get((kind, digest))
        if rec is None:
            rec = {
                "kind": kind,
                "digest": digest,
                "source": _entry_source(kind, cell),
                "meta": meta,
                "template_obj": template,
                "programs": {},
                "seen": set(),
            }
            _REC["entries"][(kind, digest)] = rec
        if prog_key in rec["seen"]:
            return
        rec["seen"].add(prog_key)
        rec["programs"][prog_key] = {"variant": variant, "donate": False, "args": specs, "bucket": bucket}
        _REC["programs"] += 1


def _members(kind: str, cell: Any) -> List[Any]:
    if kind == "encode":
        return []
    return [cell] if kind in _METRIC_KINDS else list(cell)


def _learned(kind: str, cell: Any, keys: Iterable[str]) -> Dict[str, Dict[str, Any]]:
    """The attributes each member learned in its first update, encoded."""
    from metrics_tpu_torch.metric import _encode_dynamic

    members = _members(kind, cell)
    names = list(keys) if kind not in _METRIC_KINDS else ["_"]
    return {k: {a: _encode_dynamic(getattr(m, a, None)) for a in m._dynamic_state_attrs} for k, m in zip(names, members)}


def _entry_meta(entry: Any, kind: str, cell: Any) -> Dict[str, Any]:
    meta: Dict[str, Any] = {}
    names = getattr(entry, "_member_names", None)
    if names is not None:
        meta["keys"] = list(names)
    if kind == "driver":
        meta["compute_keys"] = list(getattr(entry, "_compute_keys", ()))
        meta["hierarchical"] = False
    if kind != "encode":
        meta["dyn"] = _learned(kind, cell, meta.get("keys", ()))
    return meta


def _entry_source(kind: str, cell: Any) -> str:
    if kind in _METRIC_KINDS:
        return type(cell).__name__
    if kind == "encode":
        return getattr(cell, "name", None) or type(cell).__name__
    return "+".join(type(m).__name__ for m in cell)


def _clone_reset(metric: Any) -> Any:
    """A reset clone with the attributes the instance had when it was keyed:
    the template a later worker rebuilds the entry from."""
    tpl = metric.clone()
    tpl.reset()
    for attr, value in (metric.__dict__.get("_engine_key_dyn") or {}).items():
        setattr(tpl, attr, value)
    tpl._engine_probed = False
    return tpl


def _template_payload(kind: str, cell: Any) -> Any:
    """The manifest's recipe for an entry, or None (warmup then needs a live
    template): reset clones of the metrics; an encoder without a mesh whose
    apply function is importable by name and whose weights are small."""
    try:
        if kind in _METRIC_KINDS:
            return _clone_reset(cell)
        if kind == "encode":
            if cell.mesh is not None:
                return None
            fn = cell._apply
            module = sys.modules.get(getattr(fn, "__module__", None) or "")
            if module is None or getattr(module, getattr(fn, "__qualname__", ""), None) is not fn:
                return None
            return cell if cell.params_nbytes() <= _ENCODER_TEMPLATE_MAX_BYTES else None
        return [_clone_reset(m) for m in cell]
    except Exception:  # noqa: BLE001 — no recipe, counted at warmup
        return None


# -- the templates' pickles -----------------------------------------------
#: Module roots the template unpickler admits, and the one other class:
#: ``torch.nn.Module`` keeps its hooks in ``OrderedDict``s.
_ALLOWED_ROOTS = ("metrics_tpu_torch", "torch", "numpy", "builtins")
_ALLOWED_NAMES = (("collections", "OrderedDict"),)


class _TemplatePickler(pickle.Pickler):
    """Tensors travel as raw bytes (``persistent_id``), so a template's
    pickle never holds torch's own storage pickles."""

    def persistent_id(self, obj: Any) -> Any:
        if isinstance(obj, torch.Tensor):
            t = obj.detach().cpu().contiguous().reshape(-1)
            raw = t.view(torch.uint8).numpy().tobytes() if t.numel() else b""
            return ("tensor", _dtype_name(obj.dtype), tuple(obj.shape), str(obj.device), raw)
        return None


class _RestrictedUnpickler(pickle.Unpickler):
    """Admits classes and functions of ``metrics_tpu_torch``, ``torch``,
    ``numpy`` and builtins only (and ``collections.OrderedDict``): a
    template of another package (the JAX package's) is refused by name
    before anything of it is imported."""

    def find_class(self, module: str, name: str) -> Any:
        if module.split(".", 1)[0] in _ALLOWED_ROOTS or (module, name) in _ALLOWED_NAMES:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"warmup manifest template refers to {module}.{name}; a manifest's templates may name only"
            f" {', '.join(_ALLOWED_ROOTS)} (manifests do not cross packages)"
        )

    def persistent_load(self, pid: Any) -> Any:
        kind, dtype, shape, device, raw = pid
        if kind != "tensor":
            raise pickle.UnpicklingError(f"unknown persistent id {kind!r} in a warmup manifest template")
        dt = getattr(torch, dtype)
        t = torch.frombuffer(bytearray(raw), dtype=torch.uint8).view(dt).reshape(shape) if raw else torch.empty(shape, dtype=dt)
        return t.to(device)


def _pickle_template(obj: Any) -> Optional[str]:
    if obj is None:
        return None
    try:
        buf = io.BytesIO()
        _TemplatePickler(buf, protocol=4).dump(obj)
        return base64.b64encode(zlib.compress(buf.getvalue())).decode("ascii")
    except Exception:  # noqa: BLE001 — an unpicklable template: the manifest still carries its programs
        return None


def _unpickle_template(blob: Optional[str]) -> Any:
    if not blob:
        return None
    return _RestrictedUnpickler(io.BytesIO(zlib.decompress(base64.b64decode(blob.encode("ascii"))))).load()


# -- the document ----------------------------------------------------------
def manifest_dict() -> Dict[str, Any]:
    """The recorded programs as a manifest document, as :func:`save_manifest`
    writes it."""
    with _LOCK:
        snap = [
            {
                "kind": rec["kind"],
                "digest": rec["digest"],
                "source": rec["source"],
                "meta": json.loads(json.dumps(rec["meta"])),
                "template_obj": rec["template_obj"],
                "programs": list(rec["programs"].values()),
            }
            for rec in _REC["entries"].values()
        ]
    entries = [
        {
            "kind": rec["kind"],
            "digest": rec["digest"],
            "source": rec["source"],
            "meta": rec["meta"],
            "template": _pickle_template(rec["template_obj"]),
            "programs": rec["programs"],
        }
        for rec in snap
    ]
    return {
        "version": MANIFEST_VERSION,
        "created_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "torch_version": torch.__version__,
        # a manifest is per platform: its inputs name their devices
        "backend": "cuda" if torch.cuda.is_available() else "cpu",
        "entries": entries,
    }


def save_manifest(path: Optional[str] = None) -> str:
    """Write the recorded programs as a versioned JSON manifest (an atomic
    replace); returns the resolved path."""
    path = path or _REC["path"] or os.environ.get(ENV_VAR)
    if not path:
        raise ValueError(f"save_manifest needs a path: pass one, call record_manifest(path), or set {ENV_VAR}.")
    path = os.path.abspath(os.path.expanduser(path))
    doc = manifest_dict()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def _manifest_version_of(doc: Any) -> Any:
    return doc.get("version") if isinstance(doc, dict) else None


def _decode_manifest_doc(doc: Any, context: str) -> Dict[str, Any]:
    if not isinstance(doc, dict) or not isinstance(doc.get("entries"), list):
        raise ValueError(f"warmup manifest{context} has no entry list")
    return doc


def _upcast_manifest_v1(doc: Dict[str, Any]) -> Dict[str, Any]:
    """v1 -> v2: the same document; the bump pins the format in the registry."""
    out = dict(doc)
    out["version"] = 2
    return out


_schema.register_schema("manifest", 1, _decode_manifest_doc, upcast=_upcast_manifest_v1, prober=_manifest_version_of)
_schema.register_schema("manifest", 2, _decode_manifest_doc)


def _validate_manifest(doc: Any, origin: str) -> Dict[str, Any]:
    version = _manifest_version_of(doc)
    out = _schema.decode_any("manifest", doc, context=f" {origin}")
    if version != MANIFEST_VERSION:
        _warn_once(
            f"warmup manifest {origin} was written at schema v{version}; this build speaks v{MANIFEST_VERSION}."
            " The registry upcast it and warmup proceeds, but re-record the manifest on this build to retire"
            " the old format.",
            RuntimeWarning,
            key=("warmup_manifest_version", str(origin), version),
        )
    return out


def load_manifest(path: str) -> Dict[str, Any]:
    """Read and validate a manifest through the durable-schema registry:
    ``ValueError`` on a malformed document, ``SchemaVersionError`` on a
    newer build's (an older build's upcasts with a warning)."""
    with open(path) as f:
        doc = json.load(f)
    return _validate_manifest(doc, repr(path))


# ---------------------------------------------------------------------------
# warmup
# ---------------------------------------------------------------------------
def _template_candidates(templates: Optional[Iterable[Any]]) -> Tuple[List[Any], List[Any]]:
    """``(metrics and encoders, live banks)`` from the objects passed: a
    bank's template is a candidate too."""
    from metrics_tpu_torch.serving import MetricBank

    metrics: List[Any] = []
    banks: List[Any] = []
    for obj in templates or ():
        if isinstance(obj, MetricBank):
            banks.append(obj)
            obj = obj._template
        if hasattr(obj, "_defaults") or getattr(obj, "_is_sharded_encoder", False):
            metrics.append(obj)
    return metrics, banks


def _match_template(rec: Dict[str, Any], candidates: List[Any]) -> Optional[Any]:
    """The live template matching an entry by digest, as a warm clone
    (never the caller's instance)."""
    kind = rec.get("kind")
    if kind == "encode":
        for obj in candidates:
            if getattr(obj, "_is_sharded_encoder", False) and obj.stable_digest() == rec.get("digest"):
                return obj
        return None
    if kind != "metric_update":
        return None
    for metric in candidates:
        if not getattr(metric, "_is_sharded_encoder", False) and stable_digest(metric) == rec.get("digest"):
            return _clone_reset(metric)
    return None


def _bank_cell(bank: Any, kind: str) -> Optional[Any]:
    """A clone of the live bank's cell for ``kind``, or None where the bank
    serves no such program (a pod bank's are unrecordable)."""
    if bank._resident.layout != ((), 1, 0):
        return None
    if kind == "collection_bank":
        return [_clone_reset(m) for m in bank._cell_members] if bank._is_collection else None
    return None if bank._is_collection else _clone_reset(bank._cell_template)


def _match_bank(rec: Dict[str, Any], banks: List[Any]) -> Optional[Tuple[Any, Any]]:
    """``(bank, cell)``: the live bank an entry's programs belong to."""
    kind = rec.get("kind")
    for bank in banks:
        cell = _bank_cell(bank, kind)
        if cell is not None and _entry_digest(kind, cell, rec.get("meta", {})) == rec.get("digest"):
            return bank, cell
    return None


def _entry_for(kind: str, rec: Dict[str, Any], payload: Any, bank: Any = None) -> Tuple[Any, Any]:
    """``(cache entry, cell)`` of a manifest entry, through the factories a
    live dispatch uses, so the keys are the same."""
    if kind == "metric_update":
        key, pins = _cache.metric_fingerprint(payload)
        return _cache._get_or_create(("metric_update", key), lambda: _cache._make_metric_entry(key, pins)), payload
    if kind == "bank_update":
        return _cache.bank_entry(payload, layout=bank._resident.layout), payload
    if kind == "bank_drive":
        return _cache.bank_drive_entry(payload, layout=bank._resident.layout), payload
    if kind == "encode":
        return _cache.encoder_entry(payload), payload
    keys = tuple(rec["meta"].get("keys", ()))
    members = list(payload)
    if len(keys) != len(members):
        raise ValueError(f"manifest {kind} entry: {len(keys)} keys vs {len(members)} members")
    if kind == "collection_bank":
        return _cache.collection_bank_entry(keys, members, layout=bank._resident.layout), members
    if kind == "driver":
        from metrics_tpu_torch.engine import driver

        return driver._driver_entry(keys, members, tuple(rec["meta"].get("compute_keys", ()))), members
    return _cache.fused_entry(kind, keys, members), members


def _apply_learned(kind: str, cell: Any, rec: Dict[str, Any]) -> None:
    """Give the warm cell the attributes the recorded members had learned
    (once the entry is keyed: the key holds them as they were unlearned)."""
    from metrics_tpu_torch.metric import _decode_dynamic

    dyn = rec.get("meta", {}).get("dyn", {})
    names = ["_"] if kind in _METRIC_KINDS else rec.get("meta", {}).get("keys", ())
    for name, m in zip(names, _members(kind, cell)):
        for attr, value in dyn.get(name, {}).items():
            if value is not None and attr in m._dynamic_state_attrs:
                setattr(m, attr, _decode_dynamic(value))


def _learned_check(kind: str, cell: Any, rec: Dict[str, Any]) -> Optional[str]:
    """What the warm run left learned that differs from the recording."""
    want = rec.get("meta", {}).get("dyn", {})
    names = ["_"] if kind in _METRIC_KINDS else rec.get("meta", {}).get("keys", ())
    got = _learned(kind, cell, names)
    for name, attrs in want.items():
        for attr, value in attrs.items():
            if value is not None and got.get(name, {}).get(attr) != value:
                return (
                    f"the warm run of {rec.get('source', '')} learned {attr}={got.get(name, {}).get(attr)!r}, the"
                    f" recording {value!r}: its capture took another branch"
                )
    return None


def _snapshot_cell(kind: str, cell: Any) -> List[Tuple[Any, Dict[str, Any]]]:
    return [(m, m._snapshot_state()) for m in _members(kind, cell)]


def warmup(manifest: Optional[Any] = None, templates: Optional[Iterable[Any]] = None) -> Dict[str, Any]:
    """Make every program a manifest records before the first request.

    ``manifest`` is a path or a loaded dict (default:
    ``$METRICS_TPU_WARMUP_MANIFEST``). ``templates`` are live objects
    matched to entries by digest: metrics, ``ShardedEncoder``s, and
    ``MetricBank``s, whose programs can be warmed on them alone. Other
    entries rebuild from the manifest's embedded recipe; entries with
    neither are skipped and counted. Each program is captured (on the CPU:
    run once) under the key a live dispatch computes. Returns
    :func:`warmup_report`."""
    if manifest is None:
        manifest = os.environ.get(ENV_VAR)
        if not manifest:
            raise ValueError(f"warmup needs a manifest: pass a path/dict or set {ENV_VAR}.")
    try:
        if isinstance(manifest, dict):
            doc = _validate_manifest(manifest, "<dict>")
            path = None
        else:
            doc = load_manifest(manifest)
            path = manifest
    except SchemaVersionError as err:
        # a warm start is an optimization, never a join gate
        origin = "<dict>" if isinstance(manifest, dict) else repr(manifest)
        _warn_once(
            f"warmup manifest {origin} carries schema v{err.version}; this build speaks v{err.current}. Skipping"
            " warmup — programs will cold-compile at serve time (worker join is unaffected).",
            RuntimeWarning,
            key=("warmup_manifest_version_skew", origin, err.version),
        )
        _skip("manifest_version_skew", 1)
        if _bus.enabled():
            _bus.emit("warmup", event="version_skew", origin=origin, version=err.version, current=err.current)
        return warmup_report()
    candidates, banks = _template_candidates(templates)
    with _LOCK:
        _WARM["loaded"] = True
        if path:
            _WARM["path"] = os.path.abspath(path)
    _sync_hooks()
    for rec in doc["entries"]:
        kind = rec.get("kind")
        programs = rec.get("programs", ())
        ekey = (kind, rec.get("digest"))
        with _LOCK:
            if ekey not in _WARM["seen_entries"]:
                _WARM["seen_entries"].add(ekey)
                _WARM["manifest_entries"] += 1
            for prog in programs:
                pid = _prog_id(rec, prog)
                if pid not in _WARM["seen_programs"]:
                    _WARM["seen_programs"].add(pid)
                    _WARM["manifest_programs"] += 1
        if kind not in WARMABLE_KINDS:
            _skip("unknown_kind", len(programs))
            continue
        bank = None
        if kind in _BANK_KINDS:
            found = _match_bank(rec, banks)
            if found is None:
                _skip("bank_needs_live_bank", len(programs))
                continue
            bank, payload = found
        else:
            payload = _match_template(rec, candidates)
            if payload is None:
                try:
                    payload = _unpickle_template(rec.get("template"))
                except Exception:  # noqa: BLE001 — a foreign or stale pickle must not kill warmup
                    payload = None
            if payload is None:
                _skip("no_template", len(programs))
                continue
        try:
            entry, cell = _entry_for(kind, rec, payload, bank)
        except Exception:  # noqa: BLE001
            _skip("entry_rebuild_failed", len(programs))
            continue
        entry._warm_digest = rec.get("digest")
        _apply_learned(kind, cell, rec)
        resident = bank._resident if bank is not None else None
        warmed = [_warm_one(entry, cell, rec, prog, resident) for prog in programs]
        if any(warmed):
            with _LOCK:
                if ekey not in _WARM["counted_warmed"]:
                    _WARM["counted_warmed"].add(ekey)
                    _WARM["entries_warmed"] += 1
    if _bus.enabled():
        with _LOCK:
            warmed_n, failed, entries = _WARM["programs_warmed"], _WARM["programs_failed"], _WARM["entries_warmed"]
        _bus.emit(
            "warmup",
            source="engine",
            event="complete",
            programs_warmed=warmed_n,
            programs_failed=failed,
            entries_warmed=entries,
        )
    return warmup_report()


def _prog_id(rec: Dict[str, Any], prog: Dict[str, Any]) -> Tuple:
    blob = json.dumps([prog.get("variant"), prog.get("args")], sort_keys=True, default=str)
    return (rec.get("kind"), rec.get("digest"), hashlib.sha1(blob.encode()).hexdigest())


def _skip(reason: str, n: int) -> None:
    with _LOCK:
        _WARM["skipped"][reason] = _WARM["skipped"].get(reason, 0) + n


def _warm_one(entry: Any, cell: Any, rec: Dict[str, Any], prog: Dict[str, Any], resident: Any) -> bool:
    variant = prog.get("variant", "")
    if variant not in entry._fns:
        _skip("unknown_variant", 1)
        return False
    try:
        inputs = tuple(_decode_obj(spec) for spec in prog["args"])
        if entry.kind == "encode":
            # the encoder's own weights: they never enter the manifest
            inputs = (cell._dispatch_params(),) + inputs[1:]
    except Exception as err:  # noqa: BLE001
        _fail(rec, variant, err)
        return False
    saved = _snapshot_cell(entry.kind, cell)
    try:
        fresh = entry.warm(variant, cell, *inputs, resident=resident, check=lambda: _learned_check(entry.kind, cell, rec))
    except Exception as err:  # noqa: BLE001 — per program: count, continue
        _fail(rec, variant, err)
        return False
    finally:
        for metric, state in saved:
            metric._restore_state(state)
    if not fresh:
        return True  # warmed before (one manifest warmed again, bank by bank)
    sig = _explain.signature(_tree.flatten(inputs)[0], bucket=prog.get("bucket"), screening=entry._obs_context(cell)[1])
    with _LOCK:
        entry._warm_covered.setdefault(variant, []).append(sig)
        _WARM["programs_warmed"] += 1
    if _bus.enabled():
        _bus.emit("warmup", source=rec.get("source", ""), event="program", entry_kind=entry.kind, variant=variant)
    return True


def _fail(rec: Dict[str, Any], variant: str, err: Exception) -> None:
    with _LOCK:
        _WARM["programs_failed"] += 1
        if len(_WARM["errors"]) < _MAX_STALE_EVENTS:
            _WARM["errors"].append({"source": rec.get("source", ""), "variant": variant, "error": repr(err)[:200]})


# ---------------------------------------------------------------------------
# serve-time accounting (called by engine/cache.py)
# ---------------------------------------------------------------------------
def count_warm_hit() -> None:
    with _LOCK:
        _WARM["warmed_hits"] += 1


def note_stale(entry: Any, variant: str, sig: Dict[str, Any], source: str) -> Optional[Dict[str, Any]]:
    """A new program in a manifest-covered variant: diff its signature with
    the closest covered one, record the named change and emit
    ``warmup_stale``. Returns the explanation."""
    best: Optional[Dict[str, Any]] = None
    for promised in entry._warm_covered.get(variant, ()):
        explanation = _explain.diff(promised, sig)
        if best is None or len(explanation["changed"]) < len(best["changed"]):
            best = explanation
    if best is None:
        best = {"changed": ["unknown"], "detail": "no covered signature recorded"}
    record = {
        "source": source,
        "entry_kind": entry.kind,
        "variant": variant,
        "changed": list(best["changed"]),
        "detail": best["detail"],
    }
    with _LOCK:
        _WARM["stale_total"] += 1
        if len(_WARM["stale"]) < _MAX_STALE_EVENTS:
            _WARM["stale"].append(record)
    if _bus.enabled():
        _bus.emit("warmup_stale", source=source, entry_kind=entry.kind, variant=variant, explain=best)
    _warn_once(
        f"warmup manifest stale: {source} {entry.kind}/{variant} compiled at serve time ({best['detail']})."
        " Re-record the manifest from current traffic to restore zero-cold-start restarts.",
        RuntimeWarning,
        key=("warmup_stale", source, entry.kind, variant),
    )
    return best


# ---------------------------------------------------------------------------
# reporting and lifecycle
# ---------------------------------------------------------------------------
def warmup_report() -> Dict[str, Any]:
    """The warmup surface in one dict (``obs.snapshot()["warmup"]``, the
    ``metrics_tpu_warmup_*`` families), under the JAX package's keys:
    ``manifest_*`` describe what :func:`warmup` loaded, ``programs_warmed``
    / ``programs_failed`` / ``skipped`` / ``errors`` its outcome,
    ``warmed_hits`` the dispatches that found a warmed program,
    ``stale_total`` / ``stale`` the new programs of covered variants, and
    ``recording`` the recorder."""
    with _LOCK:
        return {
            "manifest_loaded": _WARM["loaded"],
            "manifest_path": _WARM["path"],
            "manifest_entries": _WARM["manifest_entries"],
            "manifest_programs": _WARM["manifest_programs"],
            "entries_warmed": _WARM["entries_warmed"],
            "programs_warmed": _WARM["programs_warmed"],
            "programs_failed": _WARM["programs_failed"],
            "skipped": dict(_WARM["skipped"]),
            "errors": list(_WARM["errors"]),
            "warmed_hits": _WARM["warmed_hits"],
            "stale_total": _WARM["stale_total"],
            "stale": [dict(s) for s in _WARM["stale"]],
            "recording": {
                "active": _REC["recording"],
                "path": _REC["path"],
                "entries": len(_REC["entries"]),
                "programs": _REC["programs"],
                "unrecordable": dict(_REC["unrecordable"]),
            },
        }


def reset_warmup_state() -> None:
    """Drop the recording and the warm counters. Warmed programs stay in the
    engine's cache (``engine.clear_cache()`` drops them with their entries)."""
    with _LOCK:
        _REC["recording"] = False
        _REC["path"] = None
        _REC["entries"].clear()
        _REC["programs"] = 0
        _REC["unrecordable"].clear()
        _WARM.update(
            loaded=False,
            path=None,
            manifest_entries=0,
            manifest_programs=0,
            entries_warmed=0,
            programs_warmed=0,
            programs_failed=0,
            warmed_hits=0,
            stale_total=0,
        )
        _WARM["skipped"] = {}
        _WARM["errors"] = []
        _WARM["stale"] = []
        _WARM["seen_entries"] = set()
        _WARM["seen_programs"] = set()
        _WARM["counted_warmed"] = set()
    _sync_hooks()


def _save_at_exit() -> None:
    try:
        if _REC["recording"] and _REC["entries"] and _REC["path"]:
            save_manifest()
    except Exception:  # noqa: BLE001 — exit hooks must never raise
        pass


def _maybe_autowire_from_env() -> None:
    """Import-time wiring (called at the end of ``metrics_tpu_torch``'s
    import): with ``METRICS_TPU_WARMUP_MANIFEST`` set, an existing manifest
    is warmed, a missing one recorded and saved at exit. Failures are a
    warning."""
    path = os.environ.get(ENV_VAR)
    if not path:
        return
    try:
        if os.path.exists(path):
            warmup(path)
        else:
            import atexit

            record_manifest(path)
            atexit.register(_save_at_exit)
    except Exception as err:  # noqa: BLE001 — import-time: degrade, don't die
        import warnings

        warnings.warn(f"{ENV_VAR} is set but warmup auto-wiring failed: {err}", RuntimeWarning, stacklevel=2)

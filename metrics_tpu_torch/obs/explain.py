"""Retrace explainer: name the program-key component a retrace changed
(counterpart of ``metrics_tpu/obs/explain.py``).

A retrace (a program beyond its variant's first: on the card a new CUDA
graph capture) is the costliest silent event of a streaming process. The
engine counts them (``compile_stats()['retraces']``); this module says
what changed. :func:`signature` records one dispatch's components, built
only while the event bus records:

* ``avals``: the shapes of the state and input tensors, and each
  non-tensor input **by value**. The port's program key holds a Python
  scalar by value (a CUDA graph bakes it in, where ``jax.jit`` traces it),
  so a new ``weight=3.0`` is a new program and is named here, not filed
  under ``unknown``;
* ``dtype``: the dtypes of those tensors (the type of a non-tensor input);
* ``structure``: the number of leaves (a kwarg appearing, a list growing);
* ``bucket``: the pow2 bucket a bucketed dispatch padded to;
* ``donation``: always False: the port never donates a buffer;
* ``screening``: the health policy, screen and bucketing mode.

:func:`diff` compares the previous signature of the same ``(entry,
variant)`` with the new one. The engine keeps the last signature on the
cache entry, so the explainer's memory is the entry's lifetime.
"""
from typing import Any, Dict, List, Optional, Tuple

#: Component names, in the order they are reported.
COMPONENTS = ("structure", "avals", "dtype", "bucket", "donation", "screening")

_SCALARS = (bool, int, float, complex, str, bytes, type(None))


def _leaf_desc(leaf: Any) -> Tuple[str, str]:
    """``(shape, dtype)`` of a tensor or array leaf; ``(value, type)`` of any
    other leaf (a scalar by its repr, an unhashable object by identity)."""
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is not None and dtype is not None:
        return (str(tuple(shape)), str(dtype))
    if isinstance(leaf, _SCALARS):
        value = repr(leaf)
        value = value if len(value) <= 64 else value[:61] + "..."
    else:
        try:
            hash(leaf)
            value = f"{type(leaf).__name__}:{leaf!r}"[:64]
        except TypeError:
            value = f"id:{id(leaf)}"
    return (f"py:{value}", type(leaf).__name__)


def signature(
    leaves: List[Any],
    bucket: Optional[int] = None,
    donate: bool = False,
    screening: Tuple[Any, ...] = (),
) -> Dict[str, Any]:
    """One dispatch's signature from its flattened ``(state, inputs)``
    leaves and the engine-side knobs."""
    descs = [_leaf_desc(leaf) for leaf in leaves]
    return {
        "structure": len(descs),
        "avals": tuple(d[0] for d in descs),
        "dtype": tuple(d[1] for d in descs),
        "bucket": bucket,
        "donation": bool(donate),
        "screening": tuple(screening),
    }


def _describe_change(name: str, prev: Any, new: Any) -> str:
    if name in ("avals", "dtype") and isinstance(prev, tuple) and isinstance(new, tuple) and len(prev) == len(new):
        changed = [f"leaf{i}: {p} -> {n}" for i, (p, n) in enumerate(zip(prev, new)) if p != n]
        if changed:
            return f"{name} changed ({'; '.join(changed[:4])}{', ...' if len(changed) > 4 else ''})"
    return f"{name} changed ({prev!r} -> {new!r})"


def diff(prev: Optional[Dict[str, Any]], new: Dict[str, Any]) -> Dict[str, Any]:
    """The components that differ between two signatures:
    ``{"changed": [component, ...], "detail": str}``. With no prior
    signature (the bus turned on after the family's first program) the
    cause is ``unknown``. When ``structure`` changed, the per-leaf tuples
    are not comparable and ``structure`` is reported alone."""
    if prev is None:
        return {"changed": ["unknown"], "detail": "no prior dispatch signature recorded (bus enabled mid-run?)"}
    if prev.get("structure") != new.get("structure"):
        return {
            "changed": ["structure"],
            "detail": _describe_change("structure", prev.get("structure"), new.get("structure")),
        }
    changed: List[str] = []
    details: List[str] = []
    for name in COMPONENTS:
        if name == "structure":
            continue
        if prev.get(name) != new.get(name):
            changed.append(name)
            details.append(_describe_change(name, prev.get(name), new.get(name)))
    if not changed:
        return {
            "changed": ["unknown"],
            "detail": "dispatch signature identical; the inputs moved to another device, or the cache was cleared",
        }
    return {"changed": changed, "detail": "; ".join(details)}


def record_and_explain(
    store: Dict[str, Dict[str, Any]], variant: str, sig: Dict[str, Any], is_retrace: bool
) -> Optional[Dict[str, Any]]:
    """Store ``sig`` as ``store[variant]``; on a retrace, first diff it
    against the stored predecessor and return the verdict. The caller holds
    the entry's counter lock."""
    explanation = diff(store.get(variant), sig) if is_retrace else None
    store[variant] = sig
    return explanation

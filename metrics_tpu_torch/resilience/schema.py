"""Durable-schema registry (counterpart of ``metrics_tpu/resilience/schema.py``):
one process-wide version map for every byte that outlives a process.

Each durable artifact family registers ``(family, version, decoder,
upcast)`` when the module that owns its format is imported; the highest
registered version is *current*. :func:`decode_any` reads an artifact's
version with the family's ``prober``, decodes it at that version and walks
the upcast chain to current, so bytes of an older registered version never
raise. A version ahead of current (bytes written by a newer build) raises
:class:`~metrics_tpu_torch.utils.exceptions.SchemaVersionError` naming the
family, the version and current: the downgrade guard. :func:`compat_stats`
counts decodes, upcasts and rejects per family for
``obs.snapshot()["compat"]`` and the ``metrics_tpu_compat_*`` families.

The port registers the ``wire`` family (``parallel/groups.py``); the
``journal``, ``payload``, ``manifest`` and ``snapshot`` families register
with the serving, fleet and drive layers that own them.
"""
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from metrics_tpu_torch.utils.exceptions import SchemaVersionError

__all__ = [
    "SchemaVersionError",
    "compat_stats",
    "current_version",
    "decode_any",
    "register_schema",
    "registered_families",
    "registered_versions",
    "reset_compat_stats",
]

_LOCK = threading.Lock()

# family -> version -> (decoder, upcast)
_SCHEMAS: Dict[str, Dict[int, Tuple[Callable[..., Any], Optional[Callable[[Any], Any]]]]] = {}
# family -> prober(payload) -> version   (None: caller must pass version=)
_PROBERS: Dict[str, Optional[Callable[[Any], Any]]] = {}
# family -> {"decodes": n, "upcasts": n, "rejects": n}
_STATS: Dict[str, Dict[str, int]] = {}


def _family_stats(family: str) -> Dict[str, int]:
    return _STATS.setdefault(family, {"decodes": 0, "upcasts": 0, "rejects": 0})


def register_schema(
    family: str,
    version: int,
    decoder: Callable[..., Any],
    upcast: Optional[Callable[[Any], Any]] = None,
    prober: Optional[Callable[[Any], Any]] = None,
) -> None:
    """Register one ``(family, version)`` point in the durable-schema space.

    ``decoder(payload, context) -> obj`` decodes an artifact known to be at
    ``version`` into that version's canonical object. ``upcast(obj) -> obj``
    lifts a decoded object one step toward ``version + 1``; every registered
    version below current MUST carry one (checked at decode time, not here,
    so registration order is free). ``prober(payload) -> version`` reads the
    version out of a raw artifact; registering it on any version of the
    family is enough. Re-registering a version replaces it (idempotent
    module re-imports stay safe)."""
    if not isinstance(version, int) or isinstance(version, bool):
        raise TypeError(f"schema version must be an int, got {version!r} for family {family!r}")
    with _LOCK:
        _SCHEMAS.setdefault(family, {})[version] = (decoder, upcast)
        if prober is not None or family not in _PROBERS:
            _PROBERS[family] = prober if prober is not None else _PROBERS.get(family)
        _family_stats(family)


def registered_families() -> List[str]:
    with _LOCK:
        return sorted(_SCHEMAS)


def registered_versions(family: str) -> List[int]:
    with _LOCK:
        return sorted(_SCHEMAS.get(family, ()))


def current_version(family: str) -> int:
    """The highest registered version for ``family`` — what this build
    writes, and what :func:`decode_any` upcasts everything to."""
    with _LOCK:
        versions = _SCHEMAS.get(family)
        if not versions:
            raise KeyError(f"no schemas registered for durable family {family!r}")
        return max(versions)


def _reject(family: str, version: Any, current: int, context: str) -> SchemaVersionError:
    with _LOCK:
        _family_stats(family)["rejects"] += 1
    _emit("reject", family=family, version=version, current=current)
    if isinstance(version, int) and not isinstance(version, bool) and version > current:
        return SchemaVersionError(
            f"{family} artifact{context} carries schema v{version}, but this build"
            f" speaks at most v{current} — the bytes were written by a NEWER build"
            " (downgrade guard: refusing to guess at a format from the future;"
            " upgrade this worker or decode on a current build).",
            family=family,
            version=version,
            current=current,
        )
    return SchemaVersionError(
        f"{family} artifact{context} carries unknown schema version {version!r};"
        f" this build speaks {registered_versions(family)}.",
        family=family,
        version=version,
        current=current,
    )


def _emit(event: str, **fields: Any) -> None:
    from metrics_tpu_torch.obs import bus as _bus

    if _bus.enabled():
        _bus.emit("compat", event=event, **fields)


def decode_any(
    family: str,
    payload: Any,
    *,
    version: Optional[int] = None,
    context: str = "",
) -> Any:
    """Decode an artifact of ``family`` at whatever registered version it
    carries, then walk the upcast chain to current.

    The version is read by the family's registered prober unless passed
    explicitly. Old registered versions decode and upcast transparently
    (each hop counted in :func:`compat_stats` and emitted as a ``compat``
    bus event); a version ahead of current, or unregistered, raises
    :class:`SchemaVersionError` — the downgrade guard."""
    with _LOCK:
        versions = dict(_SCHEMAS.get(family) or {})
        prober = _PROBERS.get(family)
    if not versions:
        raise KeyError(f"no schemas registered for durable family {family!r}")
    if version is None:
        if prober is None:
            raise TypeError(f"family {family!r} registered no prober; pass version= explicitly")
        version = prober(payload)
    current = max(versions)
    if version not in versions:
        raise _reject(family, version, current, context)
    decoder, _ = versions[version]
    obj = decoder(payload, context)
    with _LOCK:
        _family_stats(family)["decodes"] += 1
    hops = 0
    at = version
    while at < current:
        _, upcast = versions[at]
        if upcast is None:
            raise SchemaVersionError(
                f"{family} v{at} registered no upcast toward v{current}{context};"
                " the upcast chain is broken — register one in the owning module.",
                family=family,
                version=at,
                current=current,
            )
        obj = upcast(obj)
        at += 1
        hops += 1
    if hops:
        with _LOCK:
            _family_stats(family)["upcasts"] += hops
        _emit("upcast", family=family, **{"from": version, "to": current, "hops": hops})
    return obj


def compat_stats() -> Dict[str, Any]:
    """Per-family version-skew telemetry: registered/current versions plus
    decode/upcast/reject counters since process start (or the last reset).
    ``upcasts`` > 0 means old-format bytes are still flowing from that tier;
    ``rejects`` > 0 means something newer (or alien) knocked and was turned
    away loudly. The ``compat`` section of ``obs.snapshot()``."""
    with _LOCK:
        out: Dict[str, Any] = {}
        for family in sorted(set(_SCHEMAS) | set(_STATS)):
            versions = sorted(_SCHEMAS.get(family, ()))
            stats = _STATS.get(family, {"decodes": 0, "upcasts": 0, "rejects": 0})
            out[family] = {
                "versions": versions,
                "current": max(versions) if versions else None,
                "decodes": stats["decodes"],
                "upcasts": stats["upcasts"],
                "rejects": stats["rejects"],
            }
        return out


def reset_compat_stats() -> None:
    with _LOCK:
        for stats in _STATS.values():
            stats["decodes"] = stats["upcasts"] = stats["rejects"] = 0

"""Exporters: ``snapshot()``, the JSONL event log and a Prometheus text dump
(counterpart of ``metrics_tpu/obs/export.py``).

``snapshot(metric)`` is one nested dict of a metric's reports: its
``compile``, ``sync`` and ``health`` sections *are* the dicts
``compile_stats()``, ``sync_report()`` and ``health_report()`` return,
with wrapper children inside each section; a collection covers every
member, a tracker every step. ``snapshot()`` with no argument is the
process view: :func:`process_snapshot`, with the JAX package's top-level
keys. Its ``engine``, ``fetch``, ``encoders``, ``kernels``, ``sharding``
(:func:`~metrics_tpu_torch.sharding.shard_stats`), ``wire``
(:func:`~metrics_tpu_torch.parallel.quantize.wire_stats`), ``integrity``
(:func:`~metrics_tpu_torch.resilience.integrity.integrity_stats`),
``compat`` (the schema registry's ``families`` and the groups'
``wire_negotiation``), ``serving``
(:func:`~metrics_tpu_torch.serving.serving_summary`), ``durability``
(:func:`~metrics_tpu_torch.serving.durability_stats`), ``warmup``
(:func:`~metrics_tpu_torch.engine.warmup_report`), ``fleet``
(:func:`~metrics_tpu_torch.fleet.fleet_stats`), ``guard``
(:func:`~metrics_tpu_torch.fleet.guard_stats`, the admission control's
``overload_summary()`` folded in), ``bus``, ``spans`` and ``warnings``
sections hold the port's counters.

JSONL: one event per line in :meth:`Event.as_dict`'s schema
(``{"v": 1, "seq", "kind", "t", "source", "data"}``), checked by
:func:`validate_jsonl`; the schema is the JAX package's, so a log written
by either package validates under either.

Prometheus: text format 0.0.4 of the counters, under the JAX package's
family names (``metrics_tpu_*``) and its ``member`` labels, so a dashboard
built on the JAX package reads the port.
"""
import json
from typing import IO, Any, Dict, Iterable, List, Optional, Tuple, Union

from metrics_tpu_torch.obs import bus as _bus
from metrics_tpu_torch.obs import trace as _trace
from metrics_tpu_torch.obs import warn as _warn

JSONL_SCHEMA_VERSION = 1
_EVENT_REQUIRED_FIELDS = ("v", "seq", "kind", "t", "source", "data")

#: Sections of the JAX process snapshot that the port does not fill: none.
UNPORTED_SECTIONS: Tuple[str, ...] = ()


def _shard_stats() -> Dict[str, Any]:
    from metrics_tpu_torch.sharding import shard_stats

    return shard_stats()


def _wire_stats() -> Dict[str, Any]:
    from metrics_tpu_torch.parallel import quantize

    return quantize.wire_stats()


def _fleet_stats() -> Dict[str, Any]:
    from metrics_tpu_torch.fleet import fleet_stats

    return fleet_stats()


def _guard_stats() -> Dict[str, Any]:
    from metrics_tpu_torch.fleet import guard_stats

    return guard_stats()


def _integrity_stats() -> Dict[str, Any]:
    from metrics_tpu_torch.resilience.integrity import integrity_stats

    return integrity_stats()


def _compat_stats() -> Dict[str, Any]:
    from metrics_tpu_torch.parallel import groups
    from metrics_tpu_torch.resilience import schema

    return {"families": schema.compat_stats(), "wire_negotiation": groups.negotiation_stats()}


def _serving_summary() -> Dict[str, Any]:
    from metrics_tpu_torch.serving import serving_summary

    return serving_summary()


def _durability_stats() -> Dict[str, Any]:
    from metrics_tpu_torch.serving import durability_stats

    return durability_stats()


def _kernel_section() -> Dict[str, Any]:
    """The registry's counters: the ops ``registered``, the ``launches`` on
    the card (a graph replay credits the launches its capture recorded) and
    the ``plain_calls`` on the CPU, in all and ``by_op`` (which is
    :func:`~metrics_tpu_torch.ops.registry.kernel_stats`). The port's
    registry has no policy and no fallback."""
    from metrics_tpu_torch.ops import registry

    by_op = registry.kernel_stats()
    return {
        "registered": list(registry.registered_ops()),
        "launches": sum(rec["launches"] for rec in by_op.values()),
        "plain_calls": sum(rec["plain_calls"] for rec in by_op.values()),
        "by_op": by_op,
    }


def process_snapshot() -> Dict[str, Any]:
    """The process-wide view (no metric argument needed)."""
    from metrics_tpu_torch import engine as _engine
    from metrics_tpu_torch.encoders import encoder_stats

    out: Dict[str, Any] = {
        "engine": _engine.cache_summary(),
        "fetch": _engine.fetch_stats(),
        "encoders": encoder_stats(),
        "kernels": _kernel_section(),
        # sharded metric states: registered specs, reshard events, sharded
        # drives, per-device resident bytes
        "sharding": _shard_stats(),
        # sync wire codecs: bytes raw and encoded, payloads per codec, the
        # largest round-trip error
        "wire": _wire_stats(),
        # state digests recorded, verified and failed
        "integrity": _integrity_stats(),
        # durable-schema decodes, upcasts and rejects; wire negotiation
        "compat": _compat_stats(),
        # per-bank occupancy, evictions, launches and screening totals
        "serving": _serving_summary(),
        # journal appends and compactions, spill blobs, checkpoints, recoveries
        "durability": _durability_stats(),
        # warmup manifests: what was loaded and warmed, warmed hits, staleness
        "warmup": _engine.warmup_report(),
        # the elastic fleet: per-fleet membership and occupancy, migrations
        "fleet": _fleet_stats(),
        # gray-failure and overload defense: worker health states, hedges,
        # the exactly-once dedup proof, admission control and brownout
        "guard": _guard_stats(),
    }
    out["bus"] = _bus.summary()
    out["spans"] = _trace.span_summary()
    out["warnings"] = {repr(k): v for k, v in _warn.warn_counts().items()}
    return out


def snapshot(obj: Optional[Any] = None) -> Dict[str, Any]:
    """One nested dict of every telemetry surface: :func:`process_snapshot`
    for ``None``, else ``obj.obs_snapshot()`` (a ``Metric``,
    ``MetricCollection`` or ``MetricTracker``)."""
    if obj is None:
        return process_snapshot()
    fn = getattr(obj, "obs_snapshot", None)
    if fn is None:
        raise TypeError(
            f"obs.snapshot() needs a Metric/MetricCollection/MetricTracker"
            f" (anything with .obs_snapshot()); got {type(obj).__name__!r}."
            " Call obs.snapshot() with no argument for the process view."
        )
    return fn()


# ---------------------------------------------------------------------------
# JSONL event log
# ---------------------------------------------------------------------------
def to_jsonl(
    target: Union[str, IO[str]],
    events: Optional[Iterable[_bus.Event]] = None,
    append: bool = False,
) -> int:
    """Write ``events`` (default: the bus's buffer) to ``target``, a path or
    an open text file, one JSON object a line; returns the lines written."""
    if events is None:
        events = _bus.events()
    lines = [json.dumps(e.as_dict(), sort_keys=True, default=str) for e in events]
    if hasattr(target, "write"):
        for line in lines:
            target.write(line + "\n")
    else:
        with open(target, "a" if append else "w") as f:
            for line in lines:
                f.write(line + "\n")
    return len(lines)


def validate_jsonl(target: Union[str, IO[str]]) -> int:
    """Check a JSONL event log against the schema; returns its event count.

    Each line must be a JSON object with the required fields, schema
    version :data:`JSONL_SCHEMA_VERSION`, a ``kind`` of
    :data:`~metrics_tpu_torch.obs.bus.EVENT_KINDS`, an int ``seq``, a
    numeric ``t`` and an object ``data``. Raises ``ValueError`` naming the
    first line that is not."""
    if hasattr(target, "read"):
        lines = target.read().splitlines()
    else:
        with open(target) as f:
            lines = f.read().splitlines()
    count = 0
    for lineno, line in enumerate(lines, start=1):
        if not line.strip():
            continue
        try:
            obj = json.loads(line)
        except ValueError as err:
            raise ValueError(f"JSONL line {lineno} is not valid JSON: {err}") from err
        if not isinstance(obj, dict):
            raise ValueError(f"JSONL line {lineno} is not an object: {type(obj).__name__}")
        missing = [f for f in _EVENT_REQUIRED_FIELDS if f not in obj]
        if missing:
            raise ValueError(f"JSONL line {lineno} is missing fields {missing}")
        if obj["v"] != JSONL_SCHEMA_VERSION:
            raise ValueError(f"JSONL line {lineno} has schema version {obj['v']!r}, expected {JSONL_SCHEMA_VERSION}")
        if obj["kind"] not in _bus.EVENT_KINDS:
            raise ValueError(f"JSONL line {lineno} has unknown kind {obj['kind']!r}")
        if not isinstance(obj["seq"], int) or not isinstance(obj["t"], (int, float)):
            raise ValueError(f"JSONL line {lineno} has non-numeric seq/t")
        if not isinstance(obj["data"], dict):
            raise ValueError(f"JSONL line {lineno} has a non-object data payload")
        count += 1
    return count


# ---------------------------------------------------------------------------
# Prometheus text format
# ---------------------------------------------------------------------------
def _sanitize_label(value: Any) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", " ")


def _prom_line(name: str, value: Any, labels: Optional[Dict[str, Any]] = None) -> str:
    if labels:
        inner = ",".join(f'{k}="{_sanitize_label(v)}"' for k, v in sorted(labels.items()))
        return f"{name}{{{inner}}} {value}"
    return f"{name} {value}"


def _numeric_items(report: Dict[str, Any]) -> List[Any]:
    return [
        (k, (1 if v else 0) if isinstance(v, bool) else v)
        for k, v in report.items()
        if isinstance(v, (int, float, bool))
    ]


_ENCODER_COUNTERS = (
    "placements",
    "encode_calls",
    "fused_calls",
    "stream_chunks",
    "rows_encoded",
    "rows_screened",
    "batches_quarantined",
    "bucketed_dispatches",
)


def prometheus_text(obj: Optional[Any] = None) -> str:
    """The counters in Prometheus text exposition format: the engine (with
    the persistent kernel cache), the async fetches, the encoders, the
    kernel registry, the sharded states, the wire codecs, the serving banks,
    the fleet, the durable plane, the guard, the warmup manifests, the state
    digests, the schema registry and the wire negotiation, the bus and the
    spans; with a metric or collection, each member's compile, sync and
    health counters under a ``member`` label (a bare metric is ``_``)."""
    from metrics_tpu_torch import engine as _engine
    from metrics_tpu_torch.encoders import encoder_stats

    # one TYPE line per family, its samples contiguous: samples are gathered
    # per family (in insertion order) and rendered at the end
    families: Dict[str, Tuple[str, List[str]]] = {}

    def _sample(name: str, value: Any, labels: Optional[Dict[str, Any]] = None, kind: str = "counter") -> None:
        bucket = families.setdefault(name, (kind, []))
        bucket[1].append(_prom_line(name, value, labels))

    eng = _engine.cache_summary()
    _sample("metrics_tpu_engine_entries", eng["entries"], kind="gauge")  # LRU-evictable
    for key in ("calls", "compiles", "cache_hits", "retraces", "bucketed_calls"):
        _sample(f"metrics_tpu_engine_{key}", eng[key])
    persist = eng["persistent_cache"]
    _sample("metrics_tpu_engine_persistent_cache_enabled", 1 if persist["enabled"] else 0, kind="gauge")
    for key in ("persistent_hits", "persistent_misses"):
        _sample(f"metrics_tpu_engine_{key}", persist[key])
    fetch = _engine.fetch_stats()
    for key in ("async_fetches", "coalesced_leaves"):
        _sample(f"metrics_tpu_engine_{key}", fetch[key])

    enc = encoder_stats()
    for key in _ENCODER_COUNTERS:
        _sample(f"metrics_tpu_encoder_{key}", enc[key])
    for enc_name in sorted(enc["encoders"]):
        rec, labels = enc["encoders"][enc_name], {"encoder": enc_name}
        _sample("metrics_tpu_encoder_params_bytes_per_device", rec["params_bytes_per_device"], labels, kind="gauge")
        _sample("metrics_tpu_encoder_params_bytes_total", rec["params_bytes_total"], labels, kind="gauge")
        _sample("metrics_tpu_encoder_devices", rec["devices"], labels, kind="gauge")

    kern = _kernel_section()
    _sample("metrics_tpu_kernel_registered_ops", len(kern["registered"]), kind="gauge")
    for op_name in sorted(kern["by_op"]):
        rec = kern["by_op"][op_name]
        _sample("metrics_tpu_kernel_dispatches", rec["launches"], {"op": op_name, "path": "cuda"})
        _sample("metrics_tpu_kernel_dispatches", rec["plain_calls"], {"op": op_name, "path": "plain"})

    # sharded metric states: layout moves, sharded drives, resident bytes
    shard = _shard_stats()
    for key in ("sharded_drives", "reshard_events", "mesh_changes"):
        _sample(f"metrics_tpu_shard_{key}", shard[key])
    _sample("metrics_tpu_shard_registered_specs", len(shard["specs"]), kind="gauge")
    for state_key in sorted(shard["resident"]):
        resident = shard["resident"][state_key]
        labels = {"state": state_key, "spec": shard["specs"].get(state_key, "")}
        _sample("metrics_tpu_shard_resident_bytes_per_device", resident["per_device_bytes"], labels, kind="gauge")
        _sample("metrics_tpu_shard_state_bytes_total", resident["total_bytes"], labels, kind="gauge")
        _sample("metrics_tpu_shard_state_devices", resident["devices"], labels, kind="gauge")

    # sync wire codecs: bytes on the wire and payloads per codec
    wire = _wire_stats()
    for key in ("bytes_raw", "bytes_encoded", "bytes_raw_quantized", "bytes_encoded_quantized"):
        _sample(f"metrics_tpu_wire_{key}", wire[key])
    for codec in sorted(wire["codec_counts"]):
        _sample("metrics_tpu_wire_payloads_total", wire["codec_counts"][codec], {"codec": codec})
    _sample("metrics_tpu_wire_max_dequant_error", wire["max_dequant_error"], kind="gauge")

    # serving plane: per-bank occupancy, eviction and quarantine gauges
    for bank_name, bank in sorted(_serving_summary().items()):
        labels = {"bank": bank_name, "template": bank.get("template", "")}
        _sample("metrics_tpu_bank_capacity", bank["capacity"], labels, kind="gauge")
        _sample("metrics_tpu_bank_occupancy", bank["occupancy"], labels, kind="gauge")
        _sample("metrics_tpu_bank_spilled", bank["spilled"], labels, kind="gauge")
        for key in ("admits", "readmits", "evictions", "spills", "launches", "requests"):
            _sample(f"metrics_tpu_bank_{key}", bank[key], labels)
        # tenant-sharded (pod-scale) banks: the layout and each shard's load
        if bank.get("tenant_shards", 1) > 1:
            _sample("metrics_tpu_bank_shard_count", bank["tenant_shards"], labels, kind="gauge")
            _sample("metrics_tpu_bank_shard_capacity", bank["shard_capacity"], labels, kind="gauge")
            for shard, occ in enumerate(bank.get("shard_occupancy", [])):
                _sample("metrics_tpu_bank_shard_occupancy", occ, {**labels, "shard": str(shard)}, kind="gauge")
        if bank.get("bank_drives"):
            _sample("metrics_tpu_bank_drives", bank["bank_drives"], labels)
            _sample("metrics_tpu_bank_drive_steps", bank["drive_steps"], labels)
        if "quarantine_rate" in bank:
            _sample("metrics_tpu_bank_quarantine_rate", bank["quarantine_rate"], labels, kind="gauge")
            _sample("metrics_tpu_bank_updates_quarantined", bank["updates_quarantined"], labels)
            _sample("metrics_tpu_bank_rows_masked", bank["rows_masked"], labels)

    # warmup manifests: the warmed program inventory and staleness
    warm = _engine.warmup_report()
    _sample("metrics_tpu_warmup_manifest_loaded", 1 if warm["manifest_loaded"] else 0, kind="gauge")
    _sample("metrics_tpu_warmup_manifest_programs", warm["manifest_programs"], kind="gauge")
    for key in ("entries_warmed", "programs_warmed", "programs_failed", "warmed_hits", "stale_total"):
        _sample(f"metrics_tpu_warmup_{key}", warm[key])
    rec = warm["recording"]
    _sample("metrics_tpu_warmup_recording", 1 if rec["active"] else 0, kind="gauge")
    _sample("metrics_tpu_warmup_recorded_programs", rec["programs"], kind="gauge")

    # state digests: the failures are the alerting surface
    for key, value in sorted(_integrity_stats().items()):
        _sample(f"metrics_tpu_integrity_{key}", value)

    # version skew: per-family schema decodes, upcasts and rejects, and the
    # wire negotiation's rounds (a lasting "capped" is a mixed-version group)
    compat = _compat_stats()
    for family in sorted(compat["families"]):
        rec = compat["families"][family]
        labels = {"family": family}
        _sample("metrics_tpu_compat_schema_current", rec["current"], labels, kind="gauge")
        for key in ("decodes", "upcasts", "rejects"):
            _sample(f"metrics_tpu_compat_schema_{key}", rec[key], labels)
    for key, value in sorted(compat["wire_negotiation"].items()):
        _sample(f"metrics_tpu_compat_wire_{key}", value)

    # elastic fleet: membership, per-worker occupancy, migration traffic
    fleet = _fleet_stats()
    for key in ("migrations", "rebalance_bytes", "kills", "recovered_tenants", "epoch_changes", "upgrades", "rollbacks"):
        _sample(f"metrics_tpu_fleet_{key}", fleet[key])
    _sample("metrics_tpu_fleet_tenants", fleet["tenants"], kind="gauge")
    # parked state (park-and-retry): tenants waiting in the migration ledger
    # and requests awaiting re-submission; gauges, they drain to zero
    _sample("metrics_tpu_fleet_parked_tenants", fleet["in_flight_tenants"], kind="gauge")
    _sample("metrics_tpu_fleet_parked_requests", fleet["parked_requests"], kind="gauge")
    for fleet_name in sorted(fleet["fleets"]):
        summary = fleet["fleets"][fleet_name]
        fleet_labels = {"fleet": fleet_name, "template": summary.get("template", "")}
        _sample("metrics_tpu_fleet_epoch", summary["epoch"], fleet_labels, kind="gauge")
        _sample("metrics_tpu_fleet_workers", len(summary["workers"]), fleet_labels, kind="gauge")
        _sample("metrics_tpu_fleet_parked_tenants", summary["in_flight_tenants"], fleet_labels, kind="gauge")
        _sample("metrics_tpu_fleet_parked_requests", summary["parked_requests"], fleet_labels, kind="gauge")
        for worker_name in sorted(summary["workers"]):
            worker = summary["workers"][worker_name]
            labels = {"fleet": fleet_name, "worker": worker_name}
            _sample("metrics_tpu_fleet_tenants_owned", worker["tenants"], labels, kind="gauge")
            _sample("metrics_tpu_fleet_worker_alive", 1 if worker["alive"] else 0, labels, kind="gauge")
            for key in ("migrations_in", "migrations_out", "bytes_in", "bytes_out"):
                _sample(f"metrics_tpu_fleet_{key}", worker[key], labels)

    # durable state plane: journal, spill, checkpoint and recovery counters
    for key, value in sorted(_durability_stats().items()):
        _sample(f"metrics_tpu_durable_{key}", value)

    # gray-failure and overload defense: worker health states, the hedges'
    # lifecycle, the exactly-once dedup proof, sheds by reason, brownout
    guard = _guard_stats()
    for key in ("healthy", "probation", "ejected"):
        _sample(f"metrics_tpu_guard_workers_{key}", guard[key], kind="gauge")
    _sample("metrics_tpu_guard_outstanding_requests", guard["outstanding"], kind="gauge")
    for key in (
        "submitted",
        "applied",
        "hedges_armed",
        "hedges_delivered",
        "hedges_cancelled",
        "ejections",
        "duplicates_dropped",
        "duplicates_applied",
    ):
        _sample(f"metrics_tpu_guard_{key}", guard[key])
    overload = guard["overload"]
    _sample("metrics_tpu_guard_brownout_active", 1 if overload["brownout_active"] else 0, kind="gauge")
    for key in ("admitted", "sheds", "retries_admitted", "brownouts_entered"):
        _sample(f"metrics_tpu_guard_{key}", overload[key])
    for reason in ("tenant_quota", "inflight", "deadline", "retry_budget"):
        _sample("metrics_tpu_guard_sheds_by_reason", overload[f"shed_{reason}"], {"reason": reason})

    bus_summary = _bus.summary()
    for kind in sorted(bus_summary["by_kind"]):
        _sample("metrics_tpu_obs_events_total", bus_summary["by_kind"][kind], {"kind": kind})
    _sample("metrics_tpu_obs_events_dropped", bus_summary["dropped"])

    spans = _trace.span_summary()
    for phase in sorted(spans):
        for source in sorted(spans[phase]):
            agg = spans[phase][source]
            labels = {"phase": phase, "source": source}
            _sample("metrics_tpu_span_seconds_total", agg["total_s"], labels)
            _sample("metrics_tpu_span_count", agg["count"], labels)

    if obj is not None:
        snap = snapshot(obj)
        members = snap.get("members")
        if members is None:
            members = {"_": snap}
        for member_key in sorted(members):
            member = members[member_key]
            for surface in ("compile", "sync", "health"):
                for key, value in _numeric_items(member.get(surface, {})):
                    # a gauge: booleans, floats and counters that reset with the instance
                    _sample(
                        f"metrics_tpu_metric_{surface}_{key}",
                        value,
                        {"member": member_key, "class": member.get("class", "")},
                        kind="gauge",
                    )

    out: List[str] = []
    for name, (kind, lines) in families.items():
        out.append(f"# TYPE {name} {kind}")
        out.extend(lines)
    return "\n".join(out) + "\n"

"""The elastic fleet (counterpart of ``metrics_tpu/fleet``): rendezvous
placement, live migration, resharding, the gray-failure guard.

The serving plane makes one worker fast: banked multi-tenant waves,
quantized sync, warm starts, sharded states. This package makes those
workers a *service*: a fleet whose size and topology change underneath its
sessions without losing a bit of state.

* :mod:`~metrics_tpu_torch.fleet.placement`: coordination-free tenant to
  worker assignment, rendezvous (HRW) hashing over a versioned
  :class:`FleetEpoch`. Any peer answers "who owns tenant T at epoch E"
  locally, and a fleet-size change moves only about K/n tenants
  (:func:`assert_minimal_moves`).
* :mod:`~metrics_tpu_torch.fleet.migrate`: live migration as a composition
  of the serving plane's machinery: drain (router flush), checkpoint encode
  (the spill path), one self-describing payload riding the wire codecs,
  publish to a :class:`MigrationLedger`, ``bind_state``-validated re-admit
  on the new owner, warmed from a manifest. The ledger holds every payload
  until admission acks it, so a worker dying mid-migration loses nothing.
* :mod:`~metrics_tpu_torch.fleet.reshard`: mesh-change resharding, a
  ``[C/mp, ...]`` shard plane re-laid bit-exactly onto another ``mp``, a
  collective of the processes of both meshes.
* :mod:`~metrics_tpu_torch.fleet.router`: :class:`Fleet` (workers,
  membership, the migration engine, kill and die recovery under the fault
  harness) and :class:`FleetRouter` (the request-plane face over each
  worker's ``RequestRouter``).
* :mod:`~metrics_tpu_torch.fleet.guard`: :class:`FleetGuard`, the
  gray-failure defense: health scoring from the bus (flush-latency EWMA,
  error rate, checkpoint lag, audit verdicts) with hysteresis into healthy,
  probation and ejected (ejection rides :meth:`Fleet.kill`), and hedged
  submits with exactly-once request-id dedup. Pair it with
  :class:`~metrics_tpu_torch.resilience.overload.AdmissionController` for
  overload shedding and brownout.

Telemetry: the ``migrate``, ``fleet_epoch``, ``guard``, ``hedge`` and
``upgrade`` bus events, the ``"fleet"`` and ``"guard"`` sections of
``obs.snapshot()`` (:func:`fleet_stats`, :func:`guard_stats`), and the
``metrics_tpu_fleet_*`` and ``metrics_tpu_guard_*`` Prometheus families.
"""
from typing import Any, Dict

from metrics_tpu_torch.fleet.migrate import (  # noqa: F401
    KVLedger,
    LocalLedger,
    MigrationLedger,
    admit_payload,
    decode_tenant_payload,
    encode_tenant_payload,
    ledger_key,
)
from metrics_tpu_torch.fleet.placement import (  # noqa: F401
    FleetEpoch,
    assert_minimal_moves,
    owner,
    owners,
    partition_by_owner,
    placement_diff,
    rendezvous_score,
)
from metrics_tpu_torch.fleet.guard import FleetGuard, all_guards, guard_stats  # noqa: F401
from metrics_tpu_torch.fleet.reshard import reshard_onto  # noqa: F401
from metrics_tpu_torch.fleet.router import (  # noqa: F401
    Fleet,
    FleetRouter,
    Worker,
    all_fleets,
    fleet_summary,
)

__all__ = [
    "Fleet",
    "FleetEpoch",
    "FleetGuard",
    "FleetRouter",
    "KVLedger",
    "LocalLedger",
    "MigrationLedger",
    "Worker",
    "admit_payload",
    "all_fleets",
    "all_guards",
    "assert_minimal_moves",
    "decode_tenant_payload",
    "encode_tenant_payload",
    "fleet_stats",
    "fleet_summary",
    "guard_stats",
    "ledger_key",
    "owner",
    "owners",
    "partition_by_owner",
    "placement_diff",
    "rendezvous_score",
    "reshard_onto",
]

_AGGREGATE_KEYS = (
    "epoch_changes",
    "migrations",
    "migration_failures",
    "rebalance_bytes",
    "joins",
    "leaves",
    "kills",
    "recovered_tenants",
    "resubmitted_requests",
    # parked state (park-and-retry): tenants waiting in the migration
    # ledger + requests awaiting re-submission
    "in_flight_tenants",
    "parked_requests",
    # rolling-upgrade plane: workers replaced with a new build,
    # canary breaches that rolled the fleet back to the old build
    "upgrades",
    "rollbacks",
)


def fleet_stats() -> Dict[str, Any]:
    """Process-wide fleet telemetry: live-fleet aggregates plus the per-fleet
    summaries — the ``"fleet"`` section of ``obs.snapshot()`` and the source
    of the ``metrics_tpu_fleet_*`` Prometheus gauges."""
    fleets = fleet_summary()
    out: Dict[str, Any] = {key: 0 for key in _AGGREGATE_KEYS}
    out["tenants"] = 0
    for summary in fleets.values():
        for key in _AGGREGATE_KEYS:
            out[key] += summary.get(key, 0)
        out["tenants"] += summary.get("tenants", 0)
    out["fleets"] = fleets
    return out

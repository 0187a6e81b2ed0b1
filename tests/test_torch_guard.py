"""The port's ``FleetGuard``, guard audits and rolling upgrades against
``metrics_tpu.fleet``.

Each case runs one scenario on a JAX fleet and on a port fleet
(``device="cpu"``) with the same requests, worker ids, names, fault plans
and a fake ``clock``, and holds the observations against each other
(``run_fleets``): the guard's state walk (the states after every
observation, the streaks and reasons), its stats (hedges armed, delivered
and cancelled, ejections, absorbed errors), the dedup proof
(``duplicates_applied == 0``), the fleet stats and every tenant's value.
Scoring signals are fed as the JAX tests feed them, as synthetic ``flush``
events on each package's bus, except where a real bank's flush or audit
drives them. The scenarios' own checks, those of
``tests/fleet/test_guard.py``, ``test_guard_audit.py`` and
``tests/compat/test_rolling_upgrade.py``, run on both sides. Last, the
``"fleet"`` and ``"guard"`` sections of ``obs.snapshot()`` and their
Prometheus families against the JAX package's.
"""
import numpy as np
import pytest

from tests.test_torch_fleet import SIDES, _side, run_fleets
from tests.test_torch_serving import host

NUM_CLASSES = 4
TENANTS = [f"t{i}" for i in range(8)]


@pytest.fixture(autouse=True)
def _fresh_buses():
    for name in SIDES:
        S = _side(name)
        S.obs.bus.clear()
        S.integrity.reset_integrity_stats()
    yield
    for name in SIDES:
        S = _side(name)
        S.obs.bus.disable()
        S.obs.bus.clear()


def _sum(S):
    return S.m("SumMetric", nan_strategy="disable")


def _val(S, x=1.0, n=4):
    return S.arr(np.full(n, x, np.float32))


def _fleet(S, workers=(0, 1), name="g", **kw):
    kw.setdefault("max_delay_s", None)
    return S.fleet.Fleet(_sum(S), workers=list(workers), capacity=8, name=name, **kw)


def _emit_flush(S, fleet, wid, ms=None, error=None, n=1):
    bank = fleet._workers[wid].bank_name
    for _ in range(n):
        data = {"bank": bank, "requests": 1}
        if error is not None:
            data["error"] = error
        else:
            data["ms"] = ms
        S.obs.bus.emit("flush", source="SumMetric", **data)


def _guard_obs(guard):
    summary = guard.summary()
    return {"summary": summary, "stats": dict(guard.stats)}


# ---------------------------------------------------------------------------
# tests/fleet/test_guard.py
# ---------------------------------------------------------------------------
def _walk(S):
    """Latency, a lone spike, error-rate breach and heal, lag: the states
    after every observation."""
    walk = []
    fleet = _fleet(S)
    guard = S.fleet.FleetGuard(fleet, name="walk", latency_threshold_ms=50.0, probation_after=2, eject_after=2)
    try:
        _emit_flush(S, fleet, 0, ms=200.0, n=4)
        _emit_flush(S, fleet, 1, ms=2.0, n=4)
        walk.append(guard.observe())
        _emit_flush(S, fleet, 0, ms=200.0)
        walk.append(guard.observe())
        assert walk[-1][0] == "probation" and walk[-1][1] == "healthy"
        obs = {"latency": _guard_obs(guard)}
    finally:
        guard.close()
    fleet = _fleet(S, name="spike")
    guard = S.fleet.FleetGuard(fleet, name="spike", latency_threshold_ms=80.0, probation_after=2, eject_after=2)
    try:
        _emit_flush(S, fleet, 0, ms=100.0)
        walk.append(guard.observe())
        for _ in range(10):
            walk.append(guard.observe())  # no fresh evidence: the streak is frozen
        assert guard.summary()["workers"]["0"]["breach_streak"] == 1
        _emit_flush(S, fleet, 0, ms=2.0)
        walk.append(guard.observe())
        assert guard.summary()["workers"]["0"]["breach_streak"] == 0 and guard.stats["probations"] == 0
        obs["spike"] = _guard_obs(guard)
    finally:
        guard.close()
    fleet = _fleet(S, name="errors")
    guard = S.fleet.FleetGuard(
        fleet, name="errors", error_rate_threshold=0.5, probation_after=1, eject_after=10, recover_after=2
    )
    try:
        _emit_flush(S, fleet, 0, error="InjectedFaultError", n=4)
        walk.append(guard.observe())
        _emit_flush(S, fleet, 0, ms=2.0, n=8)
        walk.append(guard.observe())
        _emit_flush(S, fleet, 0, ms=2.0, n=2)
        walk.append(guard.observe())
        assert [w[0] for w in walk[-3:]] == ["probation", "probation", "healthy"]
        edges = [(e.data["state_from"], e.data["state_to"]) for e in S.obs.bus.events("guard")]
        assert ("healthy", "probation") in edges and ("probation", "healthy") in edges
        obs["errors"] = _guard_obs(guard)
    finally:
        guard.close()
    fleet = _fleet(S, name="lag", checkpoint_every_n_flushes=None)
    guard = S.fleet.FleetGuard(fleet, name="lag", lag_threshold=2, probation_after=1, eject_after=99)
    try:
        owner = fleet.owner_of("t0")
        for _ in range(4):
            fleet.submit("t0", _val(S))
            fleet.flush()
        assert fleet._workers[owner].bank.checkpoint_lag() >= 3
        walk.append(guard.observe())
        assert guard.worker_states()[owner] == "probation"
        assert "lag" in guard.summary()["workers"][str(owner)]["reasons"]
        obs["lag"] = {"states": guard.worker_states(), "reasons": guard.summary()["workers"][str(owner)]["reasons"]}
    finally:
        guard.close()
    for rec in obs.values():
        for w in rec.get("summary", {}).get("workers", {}).values():
            w.pop("ewma_ms", None)  # real flush times differ; the synthetic ones are compared in the walk
    obs["walk"] = [{str(k): v for k, v in w.items()} for w in walk]
    return obs


def test_guard_state_walk_matches_jax():
    run_fleets(_walk)


def _ejection(S):
    fleet = _fleet(S, workers=(0, 1, 2), name="eject")
    for t in [f"t{i}" for i in range(6)]:
        fleet.submit(t, _val(S, 2.0))
    fleet.flush()
    guard = S.fleet.FleetGuard(fleet, name="eject", latency_threshold_ms=50.0, probation_after=1, eject_after=1, min_workers=1)
    try:
        victim = fleet.owner_of("t0")
        _emit_flush(S, fleet, victim, ms=500.0, n=4)
        guard.observe()
        _emit_flush(S, fleet, victim, ms=500.0)
        guard.observe()
        assert guard.worker_states()[victim] == "ejected" and guard.stats["ejections"] == 1
        assert victim not in fleet.epoch.workers
        assert fleet.stats["kills"] == 1 and fleet.stats["recovered_tenants"] >= 1
        assert float(host(fleet.compute("t0"))) == 8.0 and fleet.owner_of("t0") != victim
        fleet.join(victim)
        guard.observe()
        assert guard.worker_states()[victim] == "healthy"  # a rejoined id is scored fresh
        _emit_flush(S, fleet, victim, ms=500.0, n=4)
        guard.observe()
        assert guard.worker_states()[victim] == "probation"
        return {"stats": dict(fleet.stats), "guard": guard.worker_states(), "gstats": dict(guard.stats), "values": {t: host(v) for t, v in fleet.compute_all().items()}}
    finally:
        guard.close()


def test_ejection_rides_fleet_kill_and_recovers_tenants():
    run_fleets(_ejection)


def _capped(S):
    fleet = _fleet(S, workers=(0,), name="capped")
    guard = S.fleet.FleetGuard(fleet, name="capped", latency_threshold_ms=10.0, probation_after=1, eject_after=1, min_workers=1)
    try:
        _emit_flush(S, fleet, 0, ms=500.0, n=3)
        with pytest.warns(UserWarning, match="ejection is capped"):
            guard.observe()
            _emit_flush(S, fleet, 0, ms=500.0)
            guard.observe()
        assert guard.worker_states()[0] == "probation" and 0 in fleet.epoch.workers
        assert guard.stats["ejections"] == 0 and guard.stats["ejections_skipped"] >= 1
        return {"stats": dict(fleet.stats), "gstats": dict(guard.stats)}
    finally:
        guard.close()


def test_min_workers_caps_ejection_and_warns():
    run_fleets(_capped)


def _hedge(S, failover):
    clock = [0.0]
    fleet = _fleet(S, workers=(0, 1, 2) if failover else (0, 1), name="hedge")
    guard = S.fleet.FleetGuard(fleet, name="hedge", min_hedge_delay_s=0.5 if failover else 0.1, clock=lambda: clock[0])
    try:
        tenant = "hedge-me"
        primary = fleet.owner_of(tenant)
        second = S.fleet.owners(tenant, fleet.epoch, k=2)[1]
        rid = guard.submit(tenant, _val(S, 5.0))
        assert fleet.has_pending_request(rid)
        guard.poll()
        assert guard.stats["hedges_armed"] == 0
        clock[0] = 1.0
        guard.poll()
        assert guard.stats["hedges_armed"] == 1
        last = S.obs.bus.events("hedge")[-1].data
        assert last["event"] == "armed" and last["failover"] == str(second)
        if failover:
            fleet.kill(primary)  # the kill path resubmits the queued original
            assert fleet.has_pending_request(rid)
            guard.poll()  # the owner changed: the hedge copy is delivered
            assert guard.stats["hedges_delivered"] == 1
            fleet.flush()
            clock[0] = 2.0
            guard.poll()
            assert fleet.request_dedup.summary()["duplicates_dropped"] == 1
        else:
            fleet.flush()  # the primary applies the original first
            guard.poll()
            assert guard.stats["hedges_cancelled"] == 1 and guard.stats["hedges_delivered"] == 0
        assert guard.outstanding == 0 and fleet.request_dedup.is_applied(tenant, rid)
        assert fleet.request_dedup.summary()["duplicates_applied"] == 0
        assert float(host(fleet.compute(tenant))) == 20.0  # one update of 4 x 5.0
        return {
            "gstats": dict(guard.stats),
            "stats": dict(fleet.stats),
            "dedup": fleet.request_dedup.summary(),
            "hedges": [e.data["event"] for e in S.obs.bus.events("hedge")],
        }
    finally:
        guard.close()


@pytest.mark.parametrize("failover", [True, False], ids=["delivered_exactly_once", "cancelled"])
def test_hedged_submits(failover):
    out = run_fleets(_hedge, failover)["torch"]
    assert out["dedup"]["duplicates_applied"] == 0


def _absorb(S):
    fleet = _fleet(S, name="absorb", max_requests=1)
    guard = S.fleet.FleetGuard(fleet, name="absorb")
    try:
        owner = fleet.owner_of("t-flaky")
        boom = [True]

        def injector():
            if boom[0]:
                boom[0] = False
                raise ConnectionError("UNAVAILABLE: injected flaky flush")

        fleet._workers[owner].bank.fault_injector = injector
        rid = guard.submit("t-flaky", _val(S, 7.0))
        assert guard.stats["submit_errors_absorbed"] == 1 and fleet.has_pending_request(rid)
        assert guard.drain()
        assert float(host(fleet.compute("t-flaky"))) == 28.0
        fleet._mark_dead(owner, reason="test")
        dead_tenant = next(f"d{i}" for i in range(100) if fleet.owner_of(f"d{i}") == owner)
        with pytest.raises(S.exc.MetricsUserError, match="is dead"):
            guard.submit(dead_tenant, _val(S))
        assert guard.outstanding == 0
        assert guard.stats["submitted"] == guard.stats["applied"] == 1
        return {"gstats": dict(guard.stats), "stats": dict(fleet.stats)}
    finally:
        guard.close()


def test_guard_absorbs_flush_errors_but_raises_enqueue_failures():
    run_fleets(_absorb)


def _surfaces(S):
    """``guard_stats()``/``fleet_stats()`` and their Prometheus families;
    parked state surfaced; departed workers pruned; a closed guard leaves a
    sibling's bus on; the kill path seals a raised cadence's tail."""
    fleet = _fleet(S, workers=(0, 1, 2), name="surf")
    guard = S.fleet.FleetGuard(fleet, name="surf", latency_threshold_ms=50.0, probation_after=1)
    sibling_fleet = _fleet(S, name="sib")
    sibling = S.fleet.FleetGuard(sibling_fleet, name="sib")
    try:
        _emit_flush(S, fleet, 0, ms=200.0, n=2)
        _emit_flush(S, fleet, 2, ms=2.0)
        guard.observe()
        stats = S.fleet.guard_stats()
        assert guard.name in stats["guards"] and stats["probation"] >= 1
        assert {"duplicates_dropped", "duplicates_applied", "overload"} <= set(stats)
        snap = S.obs.snapshot()
        assert snap["guard"]["probation"] == stats["probation"]
        fleet._in_flight["t-parked"] = "ledger-key"
        fleet._parked_requests.append(("t-parked", (_val(S),), None))
        assert fleet.summary()["in_flight_tenants"] == 1 and fleet.summary()["parked_requests"] == 1
        assert S.obs.snapshot()["fleet"]["in_flight_tenants"] >= 1
        text = S.obs.prometheus_text()
        families = sorted(
            {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE metrics_tpu_fleet_") or line.startswith("# TYPE metrics_tpu_guard_")}
        )
        assert f'fleet="{fleet.name}"' in text
        fleet._in_flight.clear()
        fleet._parked_requests.clear()
        fleet.leave(2)
        guard.observe()
        assert 2 not in guard.worker_states() and guard.summary()["healthy"] == 1
        sibling.close()
        assert S.obs.bus.enabled()  # the surf guard still needs its signal
        _emit_flush(S, fleet, 1, ms=3.0)
        assert guard.summary()["workers"]["1"]["flushes"] >= 1
        process = {
            "fleet_keys": sorted(S.obs.snapshot()["fleet"]),
            "guard_keys": sorted(S.obs.snapshot()["guard"]),
            "overload_keys": sorted(S.obs.snapshot()["guard"]["overload"]),
            "fleet_summary_keys": sorted(S.obs.snapshot()["fleet"]["fleets"]["surf"]),
            "worker_keys": sorted(S.obs.snapshot()["fleet"]["fleets"]["surf"]["workers"]["0"]),
            "guard_summary_keys": sorted(S.obs.snapshot()["guard"]["guards"]["surf"]),
        }
    finally:
        guard.close()
        sibling.close()
    assert not S.obs.bus.enabled()  # the last close restores the prior state
    cad = _fleet(S, workers=(0, 1, 2), name="cadence", checkpoint_every_n_flushes=5)
    victim = cad.owner_of("t-tail")
    for i in range(3):
        cad.submit("t-tail", _val(S, float(i + 1)))
        cad.flush()
    assert cad._workers[victim].bank.checkpoint_lag() >= 3
    cad.kill(victim)
    assert float(host(cad.compute("t-tail"))) == 24.0
    return {"families": families, "process": process, "stats": dict(cad.stats)}


def test_guard_and_fleet_telemetry_match_jax():
    out = run_fleets(_surfaces)["torch"]
    for family in (
        "metrics_tpu_guard_workers_probation",
        "metrics_tpu_guard_hedges_armed",
        "metrics_tpu_guard_duplicates_applied",
        "metrics_tpu_guard_brownout_active",
        "metrics_tpu_guard_sheds_by_reason",
        "metrics_tpu_fleet_parked_tenants",
        "metrics_tpu_fleet_tenants_owned",
        "metrics_tpu_fleet_bytes_in",
    ):
        assert family in out["families"]


# ---------------------------------------------------------------------------
# tests/fleet/test_guard_audit.py
# ---------------------------------------------------------------------------
def _traffic(S, step, i):
    rng = np.random.RandomState(1000 * step + i)
    return (
        S.arr(rng.rand(8, NUM_CLASSES).astype(np.float32)),
        S.arr(rng.randint(0, NUM_CLASSES, size=8).astype(np.int32)),
    )


def _acc(S):
    return S.m("Accuracy", num_classes=NUM_CLASSES)


def _corrupting(S):
    tenants = [f"t{i}" for i in range(6)]
    plan = S.faults.parse_plan('[{"kind": "bitflip", "rank": 1, "times": 8}]')
    fleet = S.fleet.Fleet(
        _acc(S), workers=[0, 1, 2], capacity=8, name="sdc", fault_plan=plan,
        durable_store=S.serving.MemoryStore(), checkpoint_every_n_flushes=1, audit_rate=1.0, max_delay_s=None,
    )
    guard = S.fleet.FleetGuard(
        fleet, name="sdc", probation_after=1, eject_after=2, min_workers=2,
        latency_threshold_ms=60_000.0, error_rate_threshold=0.5,
    )
    auditors = {wid: S.integrity.IntegrityAuditor(w.bank) for wid, w in fleet._workers.items()}
    applied = {t: [] for t in tenants}
    walk = []
    try:
        for step in range(12):
            for i, t in enumerate(tenants):
                args = _traffic(S, step, i)
                applied[t].append((step, i))
                guard.submit(t, *args)
            for w in fleet._workers.values():
                if w.router is not None:
                    w.router.flush()
            for wid, auditor in auditors.items():
                if fleet._workers[wid].bank is not None:
                    auditor.poll()
            states = guard.observe()
            walk.append({str(k): v for k, v in states.items()})
            if states.get(1) == "ejected":
                break
        summary = guard.summary()
    finally:
        guard.close()
    del auditors
    assert summary["workers"]["1"]["state"] == "ejected" and summary["workers"]["1"]["audit_failures"] >= 1
    for wid in ("0", "2"):
        assert summary["workers"][wid]["state"] == "healthy" and summary["workers"][wid]["audit_failures"] == 0
    assert summary["audit_failures"] == sum(r["audit_failures"] for r in summary["workers"].values())
    values = {}
    for t, steps in applied.items():
        bank = next(w.bank for w in fleet._workers.values() if w.bank is not None and (t in w.bank.tenants or t in w.bank.spilled_tenants))
        solo = _acc(S)
        for step, i in steps[: bank.update_count(t)]:
            solo.update(*_traffic(S, step, i))
        state = bank.tenant_state(t)
        for name, value in solo._snapshot_state().items():
            np.testing.assert_array_equal(host(value), host(state[name]), err_msg=f"{t}/{name}")
        values[t] = host(bank.tenant_state(t))
    for rec in summary["workers"].values():
        rec.pop("ewma_ms")
    return {"walk": walk, "summary": summary, "values": values, "stats": dict(fleet.stats), "int_states": True}


@pytest.mark.integrity
def test_bitflip_worker_walks_to_ejection_and_recovers_bit_identical():
    run_fleets(_corrupting)


# ---------------------------------------------------------------------------
# tests/compat/test_rolling_upgrade.py
# ---------------------------------------------------------------------------
def _upgrade_fleet(S, workers=(0, 1, 2), name="up"):
    return S.fleet.Fleet(
        _acc(S), workers=list(workers), capacity=8, name=name,
        durable_store=S.serving.MemoryStore(), checkpoint_every_n_flushes=1,
        max_delay_s=None, fault_plan=S.faults.parse_plan("[]"),
    )


def _pump(S, fleet, box):
    step = box[0]
    box[0] += 1
    for i, t in enumerate(TENANTS):
        fleet.submit(t, *_traffic(S, step, i))
    fleet.flush()


def _solo_values(S, n_steps):
    solo = S.serving.MetricBank(_acc(S), 8, name="solo-ref")
    for t in TENANTS:
        solo.admit(t)
    for step in range(n_steps):
        for i, t in enumerate(TENANTS):
            solo.update(t, *_traffic(S, step, i))
    return {t: host(solo.compute(t)) for t in TENANTS}


def _upgrade(S, case):
    fleet = _upgrade_fleet(S, name=f"up-{case}")
    steps = [0]
    for _ in range(2):
        _pump(S, fleet, steps)
    guard = None
    if case != "no_guard":
        guard = S.fleet.FleetGuard(
            fleet, name=f"up-{case}", probation_after=1, eject_after=2, min_workers=2,
            latency_threshold_ms=60_000.0, error_rate_threshold=0.5,
        )
    bad_plan = S.faults.parse_plan('[{"kind": "bitflip", "rank": 0, "times": 8}]')
    events = []
    S.obs.bus.subscribe(lambda e: events.append(e.data.get("event")) if e.kind == "upgrade" else None)
    factory = (lambda wid, f: f.build_worker(wid)) if case == "clean" else (lambda wid, f: f.build_worker(wid, fault_plan=bad_plan))
    try:
        report = fleet.rolling_upgrade(factory, guard=guard, canary_steps=4, on_step=lambda f: _pump(S, f, steps))
    finally:
        if guard is not None:
            guard.close()
    if case == "clean":
        assert report["rolled_back"] is False and report["breach"] is None
        assert sorted(report["upgraded"]) == [0, 1, 2] and report["audit"]["failed"] == 0
        assert fleet.stats["upgrades"] == 3 and fleet.stats["rollbacks"] == 0
    else:
        assert report["rolled_back"] is True and "integrity" in report["breach"]
        assert report["upgraded"] == [] and report["audit"]["failed"] >= 1
        assert sorted(fleet.epoch.workers) == [0, 1, 2]
        assert fleet._workers[0].bank.state_fault_injector is None  # the old build again
        _pump(S, fleet, steps)  # the rolled-back fleet keeps serving
    got = fleet.compute_all()
    want = _solo_values(S, steps[0])
    for t in TENANTS:
        assert host(got[t]).tobytes() == want[t].tobytes(), t  # no acked request lost
    if guard is not None:  # the guard turns the bus on: the lifecycle was narrated
        assert events[:3] == ["drain", "replace", "canary_hold"] and events[-1] == "complete"
    return {"report": report, "stats": dict(fleet.stats), "values": {t: host(v) for t, v in got.items()}, "int_states": True}


@pytest.mark.parametrize("case", ["clean", "rollback", "no_guard"])
def test_rolling_upgrade(case):
    run_fleets(_upgrade, case)


def _upgrade_edges(S):
    single = S.fleet.Fleet(_acc(S), workers=[0], capacity=4, name="single", max_delay_s=None)
    with pytest.raises(S.exc.MetricsUserError, match="at least 2 workers"):
        single.rolling_upgrade(lambda wid, f: f.build_worker(wid))
    fleet = _upgrade_fleet(S, workers=(0, 1), name="edges")
    steps = [0]
    _pump(S, fleet, steps)
    report = fleet.rolling_upgrade(lambda wid, f: None, canary_steps=2, on_step=lambda f: _pump(S, f, steps))
    assert report["rolled_back"] is False and sorted(report["upgraded"]) == [0, 1]
    guard = S.fleet.FleetGuard(
        fleet, name="edges", probation_after=1, eject_after=2, recover_after=2, min_workers=1,
        latency_threshold_ms=60_000.0, error_rate_threshold=0.5,
    )
    try:
        guard.hold_probation(0)
        assert guard.worker_states()[0] == "probation"
        walk = []
        for _ in range(4):
            _pump(S, fleet, steps)
            walk.append({str(k): v for k, v in guard.observe().items()})
        assert guard.worker_states()[0] == "healthy"
        assert guard.stats["probations"] == 1 and guard.stats["recoveries"] == 1
    finally:
        guard.close()
    return {"report": report, "walk": walk, "stats": dict(fleet.stats), "int_states": True}


def test_rolling_upgrade_edges_and_canary_hold():
    run_fleets(_upgrade_edges)

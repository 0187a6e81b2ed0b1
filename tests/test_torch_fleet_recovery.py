"""The port's elastic fleet and its crash recovery against ``metrics_tpu.fleet``.

Each case runs one scenario on a JAX fleet and on a port fleet
(``device="cpu"``) with the same seeded numpy requests, worker ids, fleet
names and fault plans, and holds the two observations against each other
(``run_fleets``): the move maps, every tenant's value (counts bit for bit,
float values within 1e-6), the fleet stats (``migrations``,
``recovered_tenants``, ``resubmitted_requests``, ``kills``, ``dies``, the
parked counts) and ``rebalance_bytes`` (equal for the integer-state
templates). The scenarios' own checks, those of
``tests/fleet/test_elastic_fleet.py`` and ``test_die_recovery.py``, run on
both sides: joins and kills mid-epoch against a static fleet and solo
metrics, a kill with queued requests, the ``METRICS_TPU_FAULTS`` ``kill``
and ``die`` of a migration's destination at admission, the cascade kill, a
total loss that keeps the payload in the ledger, a failed migration that
heals in the resize or on the next touch, ``die`` from a shared
``DiskStore``, the write-ahead gap, a graceful leave through the store.

The port alone: a decommissioned, killed or died worker's bank is freed
with its graphs (nothing of the fleet or a guard holds it), the fleet is
collectable, and a joining worker warmed from a recorded manifest serves
its first request with no new program.
"""
import gc
import importlib
import weakref

import numpy as np
import pytest

from tests.test_torch_fleet import _side, run_fleets
from tests.test_torch_serving import host

NUM_CLASSES = 5
N_TENANTS = 12
N_STEPS = 4


def _stream(S, seed=0, steps=N_STEPS, tenants=N_TENANTS):
    """[(step, tenant, request args)]: one request per tenant per step."""
    rng = np.random.RandomState(seed)
    out = []
    for step in range(steps):
        for i in range(tenants):
            preds = rng.rand(8, NUM_CLASSES).astype(np.float32)
            target = rng.randint(0, NUM_CLASSES, size=8).astype(np.int32)
            out.append((step, f"t{i}", (S.arr(preds), S.arr(target))))
    return out


def _acc(S):
    return S.m("Accuracy", num_classes=NUM_CLASSES)


def _sum(S):
    return S.m("SumMetric", nan_strategy="disable")


def _vec(S, rng, n=4):
    return S.arr(rng.rand(n).astype(np.float32))


def _values(fleet):
    return {str(t): host(v) for t, v in fleet.compute_all().items()}


def _moves(moves):
    return {str(t): m for t, m in moves.items()}


def _equal(got, want, what):
    for t, v in want.items():
        np.testing.assert_array_equal(got[t], v, err_msg=f"{what}: {t}")


def _static(S, stream, workers, name):
    fleet = S.fleet.Fleet(_acc(S), workers=workers, capacity=N_TENANTS, name=name, max_delay_s=None)
    router = S.fleet.FleetRouter(fleet)
    for _step, tenant, args in stream:
        router.submit(tenant, *args)
    router.flush()
    return _values(fleet)


# ---------------------------------------------------------------------------
# tests/fleet/test_elastic_fleet.py
# ---------------------------------------------------------------------------
def _elastic(S):
    stream = _stream(S)
    static = _static(S, stream, [0, 1, 2], "static")
    # solo metrics on the port's side only: the JAX values equal the port's
    # (run_fleets), and a JAX solo update is a dispatch each
    solo = {f"t{i}": _acc(S) for i in range(N_TENANTS)} if S.name == "torch" else {}
    store = S.faults.InMemoryKVStore()
    obs = {"int_states": True}
    with S.faults.simulated_world(0, 1, store.client(0)):
        fleet = S.fleet.Fleet(_acc(S), workers=[0, 1], capacity=N_TENANTS, name="elastic", max_delay_s=None, ledger=S.fleet.KVLedger())
        router = S.fleet.FleetRouter(fleet)
        last = -1
        for step, tenant, args in stream:
            if step != last:
                if step == 1:
                    moves = fleet.join(2)
                    S.fleet.assert_minimal_moves(moves, fleet.epoch.with_workers([0, 1]), fleet.epoch, n_tenants=N_TENANTS)
                    assert all(dst == 2 for _src, dst in moves.values())
                    obs["join"] = _moves(moves)
                if step == 2:
                    kill_moves = fleet.kill(1)
                    assert all(src == 1 for src, _dst in kill_moves.values())
                    obs["kill"] = _moves(kill_moves)
                last = step
            router.submit(tenant, *args)
            if solo:
                solo[tenant].update(*args)
        router.flush()
        obs["values"] = _values(fleet)
    _equal(obs["values"], static, "static fleet")
    _equal(obs["values"], {t: host(m.compute()) for t, m in solo.items()}, "solo")
    assert fleet.stats["kills"] == 1 and fleet.stats["recovered_tenants"] == len(kill_moves)
    assert fleet.epoch.version == 2 and fleet.workers == [0, 2]
    obs["stats"] = dict(fleet.stats)
    obs["summary"] = {k: v for k, v in fleet.summary().items() if k != "workers"}
    obs["workers"] = {w: {k: v for k, v in s.items()} for w, s in fleet.summary()["workers"].items()}
    return obs


def test_kill_and_join_mid_epoch_is_bit_identical_to_static_fleet():
    out = run_fleets(_elastic)["torch"]
    assert out["join"] and out["kill"]


def _kill_unflushed(S):
    fleet = S.fleet.Fleet(_sum(S), workers=[0, 1], capacity=8, name="unflushed", max_delay_s=None)
    solo = {}
    rng = np.random.RandomState(1)
    for i in range(10):
        t = f"t{i}"
        solo[t] = _sum(S)
        for _ in range(2):
            x = _vec(S, rng)
            solo[t].update(x)
            fleet.submit(t, x)
    fleet.flush()
    victim = fleet.owner_of("t0")
    queued = [t for t in solo if fleet.owner_of(t) == victim]
    for t in queued:
        x = _vec(S, rng)
        solo[t].update(x)
        fleet.submit(t, x)
    assert fleet.worker(victim).router.pending == len(queued)
    moves = fleet.kill(victim)
    assert fleet.stats["resubmitted_requests"] == len(queued)
    fleet.flush()
    values = {t: host(fleet.compute(t)) for t in solo}
    _equal(values, {t: host(m.compute()) for t, m in solo.items()}, "solo")
    return {"moves": _moves(moves), "values": values, "stats": dict(fleet.stats), "queued": queued}


def test_kill_with_unflushed_requests_resubmits_them():
    run_fleets(_kill_unflushed)


def _destination_felled_at_admit(S):
    """The plan (from ``METRICS_TPU_FAULTS``, set by the test) fells worker 2
    the moment epoch v1 asks it to admit."""
    fleet = S.fleet.Fleet(_sum(S), workers=[0, 1], capacity=16, name="plan", max_delay_s=None)
    rng = np.random.RandomState(2)
    solo = {}
    for i in range(20):
        t = f"t{i}"
        x = _vec(S, rng)
        solo[t] = _sum(S)
        solo[t].update(x)
        fleet.submit(t, x)
    fleet.flush()
    moves = fleet.join(2)
    assert fleet.stats["kills"] == 1
    assert 2 not in fleet.epoch.workers and fleet.workers == [0, 1]
    assert all(dst in (0, 1) for _src, dst in moves.values())
    dead = fleet._workers.get(2)
    values = {t: host(fleet.compute(t)) for t in solo}
    _equal(values, {t: host(m.compute()) for t, m in solo.items()}, "pre-drain state")
    assert fleet.ledger.pending() == []
    return {
        "moves": _moves(moves),
        "values": values,
        "stats": dict(fleet.stats),
        "dead_shell_memory": None if dead is None else dead.bank is not None,
    }


@pytest.mark.parametrize("kind", ["kill", "die"])
def test_fault_plan_fells_destination_at_admit(monkeypatch, kind):
    monkeypatch.setenv("METRICS_TPU_FAULTS", f'[{{"kind": "{kind}", "rank": 2, "epoch": 1}}]')
    out = run_fleets(_destination_felled_at_admit)["torch"]
    assert out["stats"]["dies"] == (1 if kind == "die" else 0)
    if kind == "die":
        assert not out["dead_shell_memory"]  # memory dropped: recovered from the store


def _plan_leave(S):
    plan = S.faults.FaultPlan([{"kind": "kill", "rank": 1, "epoch": 1}])
    fleet = S.fleet.Fleet(_sum(S), workers=[0, 1, 2], capacity=8, name="leave-plan", max_delay_s=None, fault_plan=plan)
    for i in range(12):
        fleet.submit(f"t{i}", S.arr(np.ones(4, np.float32)))
    fleet.flush()
    moves = fleet.leave(2)
    assert fleet.stats["kills"] == 1
    for i in range(12):
        assert fleet.owner_of(f"t{i}") == 0
        assert float(host(fleet.compute(f"t{i}"))) == 4.0
    # a dead owner still in the epoch refuses traffic until membership moves
    return {"moves": _moves(moves), "stats": dict(fleet.stats), "values": _values(fleet)}


def test_dead_owner_during_leave_recovers_onto_the_survivor():
    run_fleets(_plan_leave)


def _total_loss(S):
    plan = S.faults.FaultPlan([{"kind": "kill", "rank": 1, "epoch": None}])
    fleet = S.fleet.Fleet(_sum(S), workers=[0, 1], capacity=8, name="loss", max_delay_s=None, fault_plan=plan)
    fleet.submit("T", S.arr(np.ones(4, np.float32)))
    fleet.flush()
    if fleet.owner_of("T") == 1:
        fleet.kill(1)
    with pytest.raises(S.exc.MetricsUserError, match="no surviving worker"):
        fleet.kill(0)
    assert fleet.ledger.pending()  # the payload is NOT lost
    return {"stats": dict(fleet.stats), "pending": fleet.ledger.pending(), "in_flight": list(fleet._in_flight)}


def test_no_surviving_worker_keeps_payload_in_ledger():
    run_fleets(_total_loss)


def _cascade(S):
    plan = S.faults.FaultPlan([{"kind": "kill", "rank": 2, "epoch": 1}])
    fleet = S.fleet.Fleet(_sum(S), workers=[0, 1, 2], capacity=16, name="cascade", max_delay_s=None, fault_plan=plan)
    solo = {}
    rng = np.random.RandomState(3)
    for i in range(18):
        t = f"t{i}"
        x = _vec(S, rng)
        solo[t] = _sum(S)
        solo[t].update(x)
        fleet.submit(t, x)
    fleet.flush()
    assert any(fleet.owner_of(t) == 2 for t in solo)
    moves = fleet.kill(1)
    assert fleet.stats["kills"] == 2 and fleet.workers == [0]
    values = {t: host(fleet.compute(t)) for t in solo}
    _equal(values, {t: host(m.compute()) for t, m in solo.items()}, "cascade")
    assert fleet.ledger.pending() == []
    return {"moves": _moves(moves), "values": values, "stats": dict(fleet.stats)}


def test_cascade_kill_during_recovery_recovers_the_second_victim_too():
    run_fleets(_cascade)


class _FlakyLedger:
    """A LocalLedger whose first ``fail_fetches`` fetches fail, or, sticky,
    every fetch of the first key published until :meth:`heal`."""

    def __init__(self, S, fail_fetches=1, sticky=False):
        self._inner = S.fleet.LocalLedger()
        self._fail = fail_fetches
        self._sticky = sticky
        self._sticky_key = None

    def heal(self):
        self._sticky_key = None

    def publish(self, key, payload):
        if self._sticky and self._sticky_key is None:
            self._sticky_key = key
        self._inner.publish(key, payload)

    def fetch(self, key, timeout_s=5.0):
        if self._sticky:
            if key == self._sticky_key:
                raise TimeoutError("DEADLINE_EXCEEDED: injected sticky fetch failure")
        elif self._fail > 0:
            self._fail -= 1
            raise TimeoutError("DEADLINE_EXCEEDED: injected migration fetch failure")
        return self._inner.fetch(key, timeout_s)

    def ack(self, key):
        self._inner.ack(key)

    def pending(self):
        return self._inner.pending()


def _failed_fetch(S, sticky):
    ledger = _FlakyLedger(S, fail_fetches=1, sticky=sticky)
    fleet = S.fleet.Fleet(_sum(S), workers=[0, 1], capacity=16, name="flaky", max_delay_s=None, ledger=ledger)
    rng = np.random.RandomState(5)
    solo = {}
    for i in range(12):
        t = f"t{i}"
        x = _vec(S, rng)
        solo[t] = _sum(S)
        solo[t].update(x)
        fleet.submit(t, x)
    fleet.flush()
    obs = {}
    if not sticky:
        obs["moves"] = _moves(fleet.join(2))  # the sweep retried the one failed fetch
        assert not fleet._in_flight and fleet.ledger.pending() == []
        assert fleet.stats["migration_failures"] == 1
    else:
        with pytest.raises(S.exc.MetricsUserError, match="failed"):
            fleet.join(2)
        assert fleet.epoch.version == 1 and fleet.workers == [0, 1, 2]
        assert fleet.stats["migration_failures"] == 2 and len(fleet._in_flight) == 1
        (parked,) = list(fleet._in_flight)
        obs["parked"] = str(parked)
        obs["summary_parked"] = fleet.summary()["in_flight_tenants"]
        ledger.heal()
        x = _vec(S, rng)
        solo[parked].update(x)
        fleet.submit(parked, x)
        fleet.flush()
        assert not fleet._in_flight and fleet.ledger.pending() == []
    obs["values"] = {t: host(fleet.compute(t)) for t in solo}
    _equal(obs["values"], {t: host(m.compute()) for t, m in solo.items()}, "healed")
    obs["stats"] = dict(fleet.stats)
    return obs


@pytest.mark.parametrize("sticky", [False, True], ids=["heals_in_resize", "heals_on_next_touch"])
def test_failed_migration_heals(sticky):
    run_fleets(_failed_fetch, sticky)


# ---------------------------------------------------------------------------
# tests/fleet/test_die_recovery.py
# ---------------------------------------------------------------------------
def _die_mid_epoch(S):
    stream = _stream(S)
    static = _static(S, stream, [0, 1, 2], "static")
    fleet = S.fleet.Fleet(_acc(S), workers=[0, 1, 2], capacity=N_TENANTS, name="die", max_delay_s=None)
    router = S.fleet.FleetRouter(fleet)
    obs = {"int_states": True}
    for step, tenant, args in stream:
        if step == 2 and "moves" not in obs:
            router.flush()
            victim = fleet.workers[-1]
            owned = [t for t in (f"t{i}" for i in range(N_TENANTS)) if fleet.owner_of(t) == victim]
            shell = fleet._workers[victim]
            moves = fleet.die(victim)
            assert shell.bank is None and shell.router is None  # memory really gone
            assert fleet.stats["dies"] == 1 and fleet.stats["kills"] == 1
            assert victim not in fleet.epoch.workers and sorted(moves) == sorted(owned)
            live, _torn = S.store.replay_journal(shell.store, shell.bank_name)
            assert live == {}  # the dead namespace was swept
            obs["moves"] = _moves(moves)
        router.submit(tenant, *args)
    router.flush()
    obs["values"] = _values(fleet)
    _equal(obs["values"], static, "static fleet")
    obs["stats"] = dict(fleet.stats)
    return obs


def test_die_mid_epoch_is_bit_identical_to_static_fleet():
    run_fleets(_die_mid_epoch)


def _die_vs_kill(S, fell):
    stream, later = _stream(S, tenants=8, steps=1), _stream(S, seed=7, tenants=8, steps=1)
    fleet = S.fleet.Fleet(_acc(S), workers=[0, 1], capacity=N_TENANTS, name=f"fell-{fell}", max_delay_s=None)
    acked = {t: args for _, t, args in stream}
    pending = {t: args for _, t, args in later}
    for t, args in acked.items():
        fleet.submit(t, *args)
    fleet.flush()
    for t, args in pending.items():
        fleet.submit(t, *args)  # max_delay_s=None: stays queued
    victims = [t for t in acked if fleet.owner_of(t) == 0]
    assert victims
    getattr(fleet, fell)(0)
    fleet.flush()
    values = {t: host(fleet.compute(t)) for t in acked}
    for t in acked:
        solo = _acc(S)
        solo.update(*acked[t])
        if fell == "kill" or t not in victims:
            solo.update(*pending[t])
        np.testing.assert_array_equal(values[t], host(solo.compute()), err_msg=f"{fell}:{t}")
    return {"values": values, "stats": dict(fleet.stats), "int_states": True}


@pytest.mark.parametrize("fell", ["kill", "die"])
def test_die_loses_unflushed_requests_kill_does_not(fell):
    run_fleets(_die_vs_kill, fell)


def _die_disk(S, root, gap):
    store = S.serving.DiskStore(str(root / S.name))
    fleet = S.fleet.Fleet(_acc(S), workers=[0, 1], capacity=N_TENANTS, name="prod", max_delay_s=None, durable_store=store)
    solos = {}
    for _, t, args in _stream(S, tenants=10, steps=1):
        solos[t] = _acc(S)
        solos[t].update(*args)
        fleet.submit(t, *args)
    fleet.flush()
    assert fleet._workers[0].bank_name == "prod:0"
    victim = 1
    victim_tenants = [t for t in solos if fleet.owner_of(t) == victim]
    assert victim_tenants
    obs = {"int_states": True}
    if gap:
        # the write-ahead window: the journal admits a session whose blob is gone
        bank_name = fleet._workers[victim].bank_name
        store.delete(S.store.tenant_blob_key(bank_name, S.store.durable_token(victim_tenants[0])))
    obs["moves"] = _moves(fleet.die(victim))
    assert victim not in fleet._workers
    recovered = victim_tenants[1:] if gap else victim_tenants
    values = {t: host(fleet.compute(t)) for t in solos if t not in victim_tenants or t in recovered}
    _equal(values, {t: host(solos[t].compute()) for t in values}, "disk")
    if gap:
        req = _stream(S, seed=7, tenants=1, steps=1)[0][2]
        fleet.submit(victim_tenants[0], *req)
        fleet.flush()
        fresh = _acc(S)
        fresh.update(*req)
        np.testing.assert_array_equal(host(fleet.compute(victim_tenants[0])), host(fresh.compute()))
    else:
        survivor = fleet._workers[0]
        payloads = S.store.durable_tenant_payloads(store, survivor.bank_name)
        assert sorted(payloads) == sorted(t for t in solos if fleet.owner_of(t) == 0)
        recovered_bank = S.serving.MetricBank.recover(_acc(S), N_TENANTS, store, name="prod:0")
        for t in payloads:
            np.testing.assert_array_equal(host(recovered_bank.compute(t)), host(solos[t].compute()), err_msg=t)
    obs["values"] = values
    obs["stats"] = dict(fleet.stats)
    return obs


@pytest.mark.parametrize("gap", [False, True], ids=["shared_disk_store", "blob_missing"])
def test_die_recovers_from_a_disk_store(tmp_path, gap):
    run_fleets(_die_disk, tmp_path, gap)


def _graceful_leave(S):
    fleet = S.fleet.Fleet(_acc(S), workers=[0, 1], capacity=N_TENANTS, name="graceful", max_delay_s=None)
    solos = {}
    for _, t, args in _stream(S, tenants=8, steps=1):
        solos[t] = _acc(S)
        solos[t].update(*args)
        fleet.submit(t, *args)
    fleet.flush()
    shell = fleet._workers[1]
    reads = S.serving.durability_stats()["blob_reads"]
    moves = fleet.leave(1)
    assert S.serving.durability_stats()["blob_reads"] > reads  # the export read the store
    values = {t: host(fleet.compute(t)) for t in solos}
    _equal(values, {t: host(m.compute()) for t, m in solos.items()}, "leave")
    live, _torn = S.store.replay_journal(shell.store, shell.bank_name)
    assert live == {}
    with pytest.raises(KeyError):
        fleet.die(99)
    return {"moves": _moves(moves), "values": values, "stats": dict(fleet.stats), "int_states": True}


def test_graceful_leave_drains_through_the_store():
    run_fleets(_graceful_leave)


# ---------------------------------------------------------------------------
# the port alone: memory and warm joins
# ---------------------------------------------------------------------------
def test_decommissioned_and_dead_banks_are_freed():
    """A bank owns its leaves, its graphs and their pool: leave, kill and die
    drop the worker's bank, nothing of the fleet or a guard keeps it alive,
    and the fleet itself is collectable (its registry is weak)."""
    S = _side("torch")
    fleet = S.fleet.Fleet(_acc(S), workers=[0, 1, 2, 3], capacity=4, name="freed", max_delay_s=None)
    guard = S.fleet.FleetGuard(fleet, name="freed-guard")
    for _, t, args in _stream(S, tenants=8, steps=2):
        guard.submit(t, *args)
    fleet.flush()
    guard.observe()
    banks = {w: weakref.ref(fleet._workers[w].bank) for w in range(4)}
    fleet._workers[1].router.submit("t-queued", *_stream(S, seed=3, tenants=1, steps=1)[0][2])
    fleet.leave(0)
    fleet.kill(1)
    fleet.die(2)
    gc.collect()
    assert [banks[w]() is None for w in range(4)] == [True, True, True, False]
    guard.close()
    fleet_ref = weakref.ref(fleet)
    del fleet, guard
    gc.collect()
    assert fleet_ref() is None and banks[3]() is None
    assert "freed" not in S.fleet.fleet_stats()["fleets"]


def test_joining_worker_warms_from_a_manifest():
    """``join(manifest=)`` captures the joiner's programs before its first
    flush (on the CPU a warm is the program key's first eager run): the
    joiner's first wave compiles nothing, and no warm failed."""
    S = _side("torch")
    engine = S.engine
    engine.clear_cache()
    engine.record_manifest()
    try:
        fleet = S.fleet.Fleet(_acc(S), workers=[0, 1], capacity=8, name="warm", max_delay_s=None, max_requests=2)
        for _, t, args in _stream(S, tenants=8, steps=1):
            fleet.submit(t, *args)
        fleet.flush()
        doc = engine.manifest_dict()
    finally:
        importlib.import_module("metrics_tpu_torch.engine.warmup").stop_recording()
    assert doc["entries"]
    fleet.join(2, manifest=doc)
    assert fleet.stats.get("warmup_failures", 0) == 0
    joiner = fleet._workers[2]
    before = engine.cache_summary()["compiles"]
    mine = [t for _, t, _ in _stream(S, tenants=8, steps=1) if fleet.owner_of(t) == 2]
    assert mine
    # waves of two requests, the recorded waves' signature
    for seed in (9, 10):
        for _, t, args in _stream(S, seed=seed, tenants=8, steps=1):
            if t in mine:
                fleet.submit(t, *args)
    fleet.flush()
    assert engine.cache_summary()["compiles"] == before
    engine.clear_cache()

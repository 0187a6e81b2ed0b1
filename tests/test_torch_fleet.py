"""The port's fleet placement, migration and resharding
(``metrics_tpu_torch.fleet``) against ``metrics_tpu.fleet``.

Placement: the owners, the top-k failover lists, the move maps and the
partitions of 10,000 tenants of int, str, bytes and bool ids at several
epochs equal the JAX package's (the scores are BLAKE2b over type-framed
ids, so no case depends on ``hash()``), and both hold the rendezvous
properties of ``tests/fleet/test_placement.py``.

Migration: the payload codec's bytes are equal across the packages, a
payload exported by either package's bank is admitted by the other's with
equal states and values, the ledgers behave as the JAX ones, and a fleet
resize over a :class:`KVLedger` on a ``simulated_world`` client, clean and
under ``corrupt``/``drop`` plans, gives the JAX fleet's moves, stats and
values (``tests/fleet/test_migration.py``, ``test_elastic_fleet.py``).

Resharding: ``reshard_onto`` on four gloo ranks (a ``(2, 2)``
``("dp", "mp")`` mesh, moved to ``(1, 4)`` and back, ``verify=True``), each
rank a process of this file. The JAX side's ``state_spec()`` raises on a
sharded metric under jax 0.9.0, so the ranks' results are held against the
JAX unsharded values of the same inputs and against the state before the
move, not against the JAX ``reshard_onto`` (``tests/fleet/test_reshard.py``'s
checks, run on the port).
"""
import os
import socket
import subprocess
import sys
import time
from datetime import timedelta

import numpy as np
import pytest
import torch

from tests.test_torch_serving import REPO, SIDES, Side, host, same

C = 8  # classes of the reshard world: 4 rows per mp shard at mp = 2, 2 at mp = 4
WORLD = 4
WORKER_TIMEOUT_S = 120


def run_fleets(scenario, *args):
    """``run_both`` for fleet scenarios: the observations must agree, but a
    ``stats["rebalance_bytes"]`` of a float-state template. Under the x64
    test lane a JAX ``SumMetric`` bank holds its value in float64 or float32
    (by bank: the first wave's dtype) and the port's in float32, so a moved
    payload is 0 or 4 bytes longer on the JAX side; the bytes are equal
    where the states are integers (``Accuracy``, ``ConfusionMatrix``), which
    a scenario states with ``obs["int_states"]``."""
    out = {}
    for name in SIDES:
        # the program caches stay warm across scenarios: no observation
        # reads a compile count, and the JAX side's compiles are its cost
        out[name] = scenario(_side(name), *args)
    j, t = out["jax"], out["torch"]
    jb, tb = j.get("stats", {}).pop("rebalance_bytes", None), t.get("stats", {}).pop("rebalance_bytes", None)
    same(j, t)
    if tb is not None:
        moved = t["stats"]["migrations"]
        if t.get("int_states"):
            assert jb == tb, (jb, tb)
        else:
            assert (jb - tb) % 4 == 0 and 0 <= jb - tb <= 4 * moved, (jb, tb, moved)
        t["stats"]["rebalance_bytes"] = tb
    return out


def _side(S):
    """A serving ``Side`` (or a package name) with its fleet and fault modules."""
    S = Side(S) if isinstance(S, str) else S
    S.fleet = S.pkg.fleet
    S.faults = S.pkg.resilience.faults
    return S


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------
def _ids():
    ints = list(range(2500))
    strs = [f"tenant-{i}" for i in range(2500)]
    raw = [f"b{i}".encode() for i in range(2498)] + [b"", b"\xff\x00"]
    return ints + strs + raw + [True, False] + [str(i) for i in range(2498)]


EPOCHS = [
    ([0, 1, 2], 0),
    (["w0", "w1", "w2", "w3", "w4"], 3),
    ([7, "7", b"7", True, 8, 9], 11),
]


def test_placement_matches_jax_for_10000_tenants():
    from metrics_tpu import fleet as jf
    from metrics_tpu_torch import fleet as tf

    ids = _ids()
    assert len(ids) == 10_000
    # the JAX functions over its cached owner run on the ids that cache keys
    # apart: it keys True and 1 alike, so they are held against its uncached
    # rendezvous top-1 (owners(k=1)), which the port's cached owner equals
    plain = [t for t in ids if not isinstance(t, bool)]
    for workers, version in EPOCHS:
        je, te = jf.FleetEpoch(workers, version), tf.FleetEpoch(workers, version)
        assert je.workers == te.workers and je.version == te.version
        got = {(type(t), t): tf.owner(t, te) for t in ids}
        assert [got[type(t), t] for t in plain] == [jf.owner(t, je) for t in plain]
        assert [got[type(t), t] for t in (True, False)] == [jf.owners(t, je, k=1)[0] for t in (True, False)]
        assert [tf.owners(t, te, k=3) for t in ids[::7]] == [jf.owners(t, je, k=3) for t in ids[::7]]
        assert [tf.rendezvous_score(w, t) for w in workers for t in ids[::97]] == [
            jf.rendezvous_score(w, t) for w in workers for t in ids[::97]
        ]
        assert tf.partition_by_owner(plain, te) == jf.partition_by_owner(plain, je)
        part = tf.partition_by_owner(ids, te)
        # keyed by type too: True == 1 as a dict key
        assert {(type(t), t): w for w, ts in part.items() for t in ts} == got
        for nxt_t, nxt_j in ((te.join("new"), je.join("new")), (te.leave(workers[0]), je.leave(workers[0]))):
            moves = tf.placement_diff(plain, te, nxt_t)
            assert moves == jf.placement_diff(plain, je, nxt_j)
            # a move map is a dict too: the bool ids get one of their own
            bools = tf.placement_diff([True, False], te, nxt_t)
            for t in (True, False):
                was, now = jf.owners(t, je)[0], jf.owners(t, nxt_j)[0]
                assert bools.get(t) == ((was, now) if was != now else None)
            tf.assert_minimal_moves(moves, te, nxt_t, n_tenants=len(plain))
            jf.assert_minimal_moves(moves, je, nxt_j, n_tenants=len(plain))


def test_placement_properties_and_errors():
    from metrics_tpu_torch import fleet as tf

    tenants = [f"tenant-{i}" for i in range(200)]
    assert tf.rendezvous_score(1, "t0") != tf.rendezvous_score("1", "t0")
    assert tf.owner(True, tf.FleetEpoch(range(3))) == tf.owners(True, tf.FleetEpoch(range(3)))[0]
    e0 = tf.FleetEpoch(["w0", "w1"])
    e1 = e0.join("w2")
    assert (e1.version, e1.leave("w0").version) == (1, 2)
    with pytest.raises(KeyError):
        e1.leave("w9")
    e4 = tf.FleetEpoch([f"w{i}" for i in range(4)])
    for t in tenants[:50]:
        first, second = tf.owners(t, e4, k=2)
        assert tf.owner(t, e4.leave(first)) == second
    moves = tf.placement_diff(tenants, e4, e4.join("w4"))
    assert moves and all(dst == "w4" for _, dst in moves.values())
    with pytest.raises(AssertionError, match="survivors must not trade"):
        tf.assert_minimal_moves({"t": ("w0", "w1")}, e0, e1)
    with pytest.raises(ValueError, match="no workers"):
        tf.owner("t", tf.FleetEpoch([]))


# ---------------------------------------------------------------------------
# migration payloads
# ---------------------------------------------------------------------------
def _req(S, seed, batch=8, classes=5):
    rng = np.random.RandomState(seed)
    return (
        S.arr(rng.rand(batch, classes).astype(np.float32)),
        S.arr(rng.randint(0, classes, size=batch).astype(np.int32)),
    )


def _cm_req(S, seed, batch=8, classes=5):
    rng = np.random.RandomState(seed)
    return (
        S.arr(rng.randint(0, classes, size=batch).astype(np.int32)),
        S.arr(rng.randint(0, classes, size=batch).astype(np.int32)),
    )


def test_payload_codec_bytes_equal_jax():
    from metrics_tpu import fleet as jf
    from metrics_tpu_torch import fleet as tf
    from metrics_tpu_torch.utils.exceptions import MetricsUserError, SyncIntegrityError

    big = np.random.RandomState(0).rand(4096).astype(np.float32)
    tree = {"_update_count": 3, "feats": big, "ids": np.arange(4096, dtype=np.int64)}
    for precisions in (None, {"feats": "bf16", "ids": "bf16"}):
        payload = tf.encode_tenant_payload(tree, precisions)
        assert payload == jf.encode_tenant_payload(tree, precisions)
        out, jout = tf.decode_tenant_payload(payload), jf.decode_tenant_payload(payload)
        same(host(jout), host(out))
        assert tf.migrate.reencode_payload(payload, None) is payload
    narrow = tf.encode_tenant_payload(tree, {"feats": "bf16"})
    assert len(tf.encode_tenant_payload(tree)) - len(narrow) > 7000
    corrupted = bytearray(narrow)
    corrupted[len(corrupted) // 2] ^= 0xFF
    with pytest.raises(SyncIntegrityError):
        tf.decode_tenant_payload(bytes(corrupted))
    with pytest.raises(MetricsUserError, match="list"):
        tf.encode_tenant_payload({"_update_count": 0, "buf": {"0": np.ones(3)}})
    assert tf.ledger_key("f", 3, 7) == jf.ledger_key("f", 3, 7) == "mtpu-fleet/f/3/7"
    for tenant in ("7", b"7", True, ("a", 1)):
        assert tf.ledger_key("f", 3, tenant) == jf.ledger_key("f", 3, tenant)


@pytest.mark.parametrize("template", ["Accuracy", "ConfusionMatrix"])
@pytest.mark.parametrize("writer", SIDES)
def test_payload_crosses_the_packages(template, writer):
    """A tenant exported by one package's bank is admitted by the other's:
    equal payload bytes, equal states, equal values, and it keeps serving."""
    W, R = _side(writer), _side("torch" if writer == "jax" else "jax")
    make = _req if template == "Accuracy" else _cm_req
    payloads, banks = {}, {}
    for S in (W, R):
        src = S.bank(S.m(template, num_classes=5), capacity=4, name="mig-src")
        for i in range(3):
            src.update("T", *make(S, i))
        payloads[S.name] = src.export_payload("T")
        assert "T" not in src.tenants and "T" not in src.spilled_tenants
    assert payloads["jax"] == payloads["torch"]
    for S in (W, R):
        dst = S.bank(S.m(template, num_classes=5), capacity=4, name="mig-dst")
        n = S.fleet.admit_payload(dst, "T", payloads[writer])
        assert n == len(payloads[writer]) and dst.update_count("T") == 3
        dst.update("T", *make(S, 3))
        banks[S.name] = {"state": host(dst.tenant_state("T")), "value": host(dst.compute("T"))}
    same(banks["jax"], banks["torch"])


def test_ledgers_hold_payloads_until_acked():
    for name in SIDES:
        S = _side(name)
        ledger = S.fleet.LocalLedger()
        key = S.fleet.ledger_key("f", 3, "T")
        ledger.publish(key, b"payload-bytes")
        assert ledger.pending() == [key]
        assert ledger.fetch(key) == ledger.fetch(key) == b"payload-bytes"
        ledger.ack(key)
        assert ledger.pending() == []
        with pytest.raises(TimeoutError):
            ledger.fetch(key, timeout_s=0.01)
        store = S.faults.InMemoryKVStore()
        kv = S.fleet.KVLedger(store.client(0))
        kv.publish(key, b"kv")
        assert kv.pending() == [key] and kv.fetch(key) == b"kv"
        kv.ack(key)
        assert kv.pending() == []
        with pytest.raises(TimeoutError, match="DEADLINE_EXCEEDED"):
            kv.fetch(key, timeout_s=0.01)


class _QuickKV:
    """A :class:`KVLedger` whose fetch waits 50 ms, not 5 s: a dropped
    payload times out at once (the ledger's behaviour, not its patience, is
    under test)."""

    def __init__(self, S):
        self.inner = S.fleet.KVLedger()

    def publish(self, key, payload):
        self.inner.publish(key, payload)

    def fetch(self, key, timeout_s=0.05):
        return self.inner.fetch(key, timeout_s)

    def ack(self, key):
        self.inner.ack(key)

    def pending(self):
        return self.inner.pending()


def _kv_resize(S, plan):
    """A fleet of workers [0, 1] over a KVLedger in a simulated world whose
    store carries ``plan``; 12 integer tenants, then join(2). Integer tenant
    ids make the payloads targetable: the fault plans parse ``(epoch, rank)``
    off the ledger key's tail."""
    S = _side(S)
    store = S.faults.InMemoryKVStore(S.faults.FaultPlan(plan))
    obs = {}
    with S.faults.simulated_world(0, 1, store.client(0)):
        fleet = S.fleet.Fleet(
            S.m("SumMetric", nan_strategy="disable"), workers=[0, 1], capacity=16,
            name="kv", max_delay_s=None, ledger=_QuickKV(S),
        )
        rng = np.random.RandomState(4)
        for t in range(12):
            fleet.submit(t, S.arr(rng.rand(4).astype(np.float32)))
        fleet.flush()
        try:
            obs["moves"] = {str(t): m for t, m in fleet.join(2).items()}
            obs["error"] = None
        except Exception as err:  # noqa: BLE001 - the parked failure is the observation
            obs["error"] = type(err).__name__
            obs["moves"] = {}
        obs["in_flight"] = sorted(map(str, fleet._in_flight))
        obs["stats"] = dict(fleet.stats)
        # a parked tenant heals on its next touch; a dropped payload never does
        try:
            obs["values"] = {str(t): host(v) for t, v in fleet.compute_all().items()}
        except Exception as err:  # noqa: BLE001
            obs["values"] = {str(t): host(fleet.compute(t)) for t in fleet.tenants if t not in fleet._in_flight}
            obs["heal_error"] = type(err).__name__
        obs["pending_after"] = fleet.ledger.pending()
        obs["log_ops"] = sorted({op for op, _, key in store.log if key.startswith("mtpu-fleet/kv/")})
    return obs


@pytest.mark.parametrize(
    "plan",
    [
        [],
        [{"kind": "corrupt", "rank": 6, "epoch": 1, "times": 1}],
        [{"kind": "drop", "rank": 6, "epoch": 1}],
    ],
    ids=["clean", "corrupt", "drop"],
)
def test_kv_ledger_resize_under_fault_plans(plan):
    """Over the simulated coordination store: a clean resize; a corrupted
    payload read (caught by the crc32 envelope, healed by the in-resize
    retry sweep); a dropped payload (parked in the ledger record, the epoch
    committed, the error raised after commit). Moves, stats and values
    equal the JAX fleet's."""
    out = run_fleets(_kv_resize, plan)["torch"]
    moved = set(out["moves"])
    if not plan or plan[0]["kind"] == "corrupt":
        assert out["error"] is None and out["in_flight"] == [] and out["pending_after"] == []
        assert out["stats"]["migration_failures"] == (1 if plan else 0)
        # tenant 6, the plans' target, is one of the four the join moves
        assert moved == {"0", "4", "6", "11"} and all(dst == 2 for _, dst in out["moves"].values())
    else:
        assert out["error"] == "MetricsUserError" and out["in_flight"] == ["6"]
        assert out["heal_error"] == "KVTimeoutError" and len(out["values"]) == 11
        assert out["stats"]["migration_failures"] == 2 and out["stats"]["migrations"] == 3
    assert set(out["log_ops"]) >= {"set", "get"}


# ---------------------------------------------------------------------------
# resharding: four gloo ranks
# ---------------------------------------------------------------------------
def _epochs(seed=16, steps=4, batch=8):
    rng = np.random.RandomState(seed)
    return [
        (rng.randint(0, C, size=(steps, batch)).astype(np.int32), rng.randint(0, C, size=(steps, batch)).astype(np.int32))
        for _ in range(2)
    ]


def _rank_cases(rank, mt, engine, P, init_device_mesh):
    from metrics_tpu_torch.fleet import reshard_onto
    from metrics_tpu_torch.sharding import spec as shd
    from metrics_tpu_torch.utils.exceptions import MetricsUserError

    out = {}
    (p1, t1), (p2, t2) = [(torch.from_numpy(p), torch.from_numpy(t)) for p, t in _epochs()]
    mesh22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("dp", "mp"))
    mesh14 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("dp", "mp"))
    shd.reset_shard_stats()
    cm = mt.ConfusionMatrix(num_classes=C, class_sharding="mp", device="cpu")
    engine.drive(cm, (p1, t1), mesh=mesh22, in_specs=P(None, "dp"))
    out["before"] = cm.compute().clone()
    out["shard22"] = tuple(cm.confmat.shape)
    with mt.obs.capture() as events:
        t0 = time.perf_counter()
        reshard_onto(cm, mesh14, verify=True)
        out["ms_to_14"] = (time.perf_counter() - t0) * 1e3
    out["shard14"] = tuple(cm.confmat.shape)
    out["at14"] = cm.compute().clone()
    out["events"] = [e.kind for e in events]
    t0 = time.perf_counter()
    reshard_onto(cm, mesh22, verify=True)
    out["ms_to_22"] = (time.perf_counter() - t0) * 1e3
    out["back22"] = cm.compute().clone()
    out["mesh_changes"] = shd.shard_stats()["mesh_changes"]
    # keeps serving on the new mesh: a second epoch driven there, reset there
    cm2 = mt.ConfusionMatrix(num_classes=C, class_sharding="mp", device="cpu")
    engine.drive(cm2, (p1, t1), mesh=mesh22, in_specs=P(None, "dp"))
    reshard_onto(cm2, mesh14)
    engine.drive(cm2, (p2, t2), mesh=mesh14, in_specs=P(None, "dp"))
    out["two_epochs"] = cm2.compute().clone()
    cm2.reset()
    out["reset_shape"] = tuple(cm2.confmat.shape)
    # validation through state_spec(), and a metric with nothing to re-lay
    ss = mt.StatScores(reduce="macro", num_classes=C, class_sharding="mp", device="cpu")
    ss.shard_states(mesh22)
    out["ss_spec"] = str(ss.state_spec()["tp"].sharding)
    ss.tp = torch.zeros(C + 1, dtype=ss.tp.dtype)
    try:
        reshard_onto(ss, mesh14)
        out["ss_error"] = "no error"
    except MetricsUserError as err:
        out["ss_error"] = str(err)
    try:
        reshard_onto(mt.SumMetric(nan_strategy="disable", device="cpu"), mesh14)
        out["sum_error"] = "no error"
    except MetricsUserError as err:
        out["sum_error"] = str(err)
    return out


def _worker(rank: int, world: int, port: int, out_path: str) -> None:
    sys.path.insert(0, REPO)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import metrics_tpu_torch as mt
    from metrics_tpu_torch import engine
    from metrics_tpu_torch.sharding import PartitionSpec as P

    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank, timeout=timedelta(seconds=60)
    )
    results = _rank_cases(rank, mt, engine, P, init_device_mesh)
    torch.save(results, out_path)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def reshard_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reshard_world")
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO}
    procs, paths = [], []
    for rank in range(WORLD):
        path = str(tmp / f"rank{rank}.pt")
        log = open(tmp / f"rank{rank}.log", "w+")
        cmd = [sys.executable, os.path.abspath(__file__), str(rank), str(WORLD), str(port), path]
        procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO), log))
        paths.append(path)
    failures = []
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    try:
        for rank, (proc, _) in enumerate(procs):
            try:
                rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = f"killed after {WORKER_TIMEOUT_S} s"
            if rc != 0:
                failures.append((rank, rc))
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    logs = []
    for rank, (_, log) in enumerate(procs):
        log.seek(0)
        logs.append(f"--- rank {rank} ---\n{log.read()[-4000:]}")
        log.close()
    if failures:
        pytest.fail(f"workers failed {failures}:\n" + "\n".join(logs))
    return [torch.load(p, weights_only=False) for p in paths]


def _jax_confmat(*epochs):
    import jax.numpy as jnp

    from metrics_tpu import ConfusionMatrix, engine

    cm = ConfusionMatrix(num_classes=C)
    for preds, target in epochs:
        engine.drive(cm, (jnp.asarray(preds), jnp.asarray(target)))
    return np.asarray(cm.compute())


def test_reshard_round_trip_is_bit_exact(reshard_world):
    """[C/mp, C] driven at (2, 2), re-laid to (1, 4) and back with
    ``verify=True`` (a gathered comparison of the global state on every
    rank): bit-identical at every hop, equal to the JAX unsharded matrix."""
    e1, _ = _epochs()
    want = _jax_confmat(e1)
    for r in reshard_world:
        assert r["shard22"] == (C // 2, C) and r["shard14"] == (C // 4, C)
        for key in ("before", "at14", "back22"):
            np.testing.assert_array_equal(r[key].numpy(), want, err_msg=key)
        assert r["mesh_changes"] == 2
        assert "reshard" in r["events"]


def test_resharded_metric_keeps_serving_on_the_new_mesh(reshard_world):
    want = _jax_confmat(*_epochs())
    for r in reshard_world:
        np.testing.assert_array_equal(r["two_epochs"].numpy(), want)
        assert r["reset_shape"] == (C // 4, C)  # fresh defaults placed on the NEW mesh


def test_reshard_validates_and_requires_annotations(reshard_world):
    for r in reshard_world:
        assert r["ss_spec"] == "PartitionSpec('mp',)"
        assert "StatScores.tp" in r["ss_error"]
        assert "registers no" in r["sum_error"]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

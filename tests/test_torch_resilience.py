"""The port's resilient sync (``metrics_tpu_torch.resilience`` and
``parallel/groups.py``) against ``metrics_tpu`` on the same inputs.

Simulated worlds, as the JAX package's ``tests/resilience/`` runs them:
threads act as processes, each inside ``simulated_world`` over a shared
in-memory store (``run_as_peers``), so deadlines, retries and partial
results run for real on the CPU. Held against the JAX package:

* ``RetryPolicy`` budgets and backoffs value for value, ``parse_plan`` on
  the same texts;
* the exchange under ``drop``, ``delay``, ``straggler``, ``corrupt`` and
  ``flaky`` plans: each rank's payloads, ``missing_ranks`` and the counters
  a plan fixes (``retries``, ``integrity_failures``, ``attempts``,
  ``kv_timeouts``), and under the raise policy the same failures;
* the same exchanges through ``StoreClient`` over a ``torch.distributed``
  ``HashStore`` with the plan in a ``FaultyClient``;
* one group of a JAX peer and port peers on one shared store, each side
  decoding the other's payloads;
* ``speaking(1)``: the group settles on v1, tagged leaves travel exact and
  ``negotiation_stats()`` counts it as the JAX package does;
* the state digests of every dtype (bfloat16 included) and
  ``verify_tree``'s raise;
* ``AdmissionController`` on an injected clock over a scripted trace;
* ``Accuracy``, ``ConfusionMatrix`` and a float metric tagged ``int8`` and
  ``bf16`` under ``on_sync_error`` raise, local and partial with a dropped
  peer: ``compute()`` and ``sync_report()`` equal to the JAX package's.

Deadlines are at most 2 s; no test opens a TCP port.
"""
import json
import threading
import time
import warnings

import numpy as np
import pytest
import torch

FAST = dict(max_attempts=3, backoff_base_s=0.01, backoff_max_s=0.05)
_seq = [0]


def _name(prefix: str) -> str:
    _seq[0] += 1
    return f"{prefix}{_seq[0]}"


def _pkgs():
    import metrics_tpu as mj
    import metrics_tpu_torch as mt

    return mj, mt


def _groups(pkg):
    return pkg.parallel.groups


def _group(pkg, world, name, timeout_s=1.5):
    return pkg.parallel.new_group(range(world), name=name, timeout_s=timeout_s, retry=pkg.resilience.RetryPolicy(**FAST))


# ---------------------------------------------------------------------------
# retry policy and fault plans
# ---------------------------------------------------------------------------
def test_retry_policy_budgets_and_backoffs_equal_jax():
    mj, mt = _pkgs()
    for kw in ({}, FAST, dict(max_attempts=5, backoff_base_s=0.2, backoff_max_s=0.5, jitter=0.0), dict(jitter=1.0)):
        j, p = mj.resilience.RetryPolicy(**kw), mt.resilience.RetryPolicy(**kw)
        for remaining in (0.0, 0.0005, 1.0, 7.5):
            for left in (0, 1, 2, 5):
                assert p.attempt_timeout_s(remaining, left) == j.attempt_timeout_s(remaining, left)
        for attempt in range(1, 8):
            for key in ((), ("scope:0-1", 3, 1), ("g", 0, 2)):
                assert p.backoff_s(attempt, key) == j.backoff_s(attempt, key)
    assert mt.resilience.DEFAULT_RETRY == mt.resilience.RetryPolicy()
    for bad in (dict(max_attempts=0), dict(jitter=1.5), dict(backoff_base_s=-1)):
        with pytest.raises(ValueError):
            mt.resilience.RetryPolicy(**bad)


PLAN_TEXTS = (
    '[{"kind": "drop", "rank": 1, "epoch": 0}]',
    '[{"kind": "corrupt", "rank": 1, "times": 2}, {"kind": "straggler", "rank": 0, "seconds": 0.1}]',
    '[{"kind": "delay", "rank": 2, "epoch": 3, "seconds": 0.5}, {"kind": "flaky", "rank": 1, "times": 3}]',
    '[{"kind": "kill", "rank": 0}, {"kind": "die", "rank": 1, "epoch": 2}, {"kind": "slow", "rank": 2},'
    ' {"kind": "bitflip", "rank": 0, "times": 4}]',
    "[]",
)
BAD_PLANS = ('{"kind": "drop"}', '[{"kind": "explode", "rank": 0}]', '[{"kind": "drop", "rank": 0, "when": 1}]', "[3]")


def test_parse_plan_equals_jax_on_the_same_texts(tmp_path, monkeypatch):
    mj, mt = _pkgs()
    jf, pf = mj.resilience.faults, mt.resilience.faults
    for text in PLAN_TEXTS:
        j, p = jf.parse_plan(text), pf.parse_plan(text)
        assert [vars(s) for s in p] == [vars(s) for s in j]
        for rank in range(3):
            for epoch in (None, 0, 2, 3):
                assert p.kills(rank, epoch) == j.kills(rank, epoch) and p.dies(rank, epoch) == j.dies(rank, epoch)
                assert p.slow_s(rank, epoch) == j.slow_s(rank, epoch)
                key = f"metrics_tpu/pg/g:0-1-2/{epoch or 0}/{rank}"
                assert p.drops_publish(key) == j.drops_publish(key)
                assert p.read_delay_s(key) == j.read_delay_s(key)
                assert p.publish_visible_delay_s(key) == j.publish_visible_delay_s(key)
        assert [p.flaky_fails(1) for _ in range(8)] == [j.flaky_fails(1) for _ in range(8)]
        assert [p.bitflip_site(0) for _ in range(6)] == [j.bitflip_site(0) for _ in range(6)]
    for text in BAD_PLANS:
        with pytest.raises(ValueError) as jerr:
            jf.parse_plan(text)
        with pytest.raises(ValueError) as perr:
            pf.parse_plan(text)
        assert str(perr.value) == str(jerr.value)
    path = tmp_path / "plan.json"
    path.write_text(PLAN_TEXTS[1])
    for raw in (PLAN_TEXTS[0], f"@{path}"):
        monkeypatch.setenv("METRICS_TPU_FAULTS", raw)
        assert [vars(s) for s in pf.plan_from_env()] == [vars(s) for s in jf.plan_from_env()]
    monkeypatch.setenv("METRICS_TPU_FAULTS", "")
    assert pf.plan_from_env() is None
    assert pf.corrupt_bytes(b"abcdef") == jf.corrupt_bytes(b"abcdef") and pf.corrupt_bytes(b"") == b"\xff"


# ---------------------------------------------------------------------------
# the exchange under fault plans: port against JAX
# ---------------------------------------------------------------------------
# (world, plan, policy, timeout_s, the report keys the plan fixes)
SCENARIOS = {
    "clean": (3, [], "raise", 1.5, ("retries", "integrity_failures", "kv_timeouts", "attempts")),
    "corrupt_once": (2, [("corrupt", 1, 0, 0.25, 1)], "raise", 1.5, ("retries", "integrity_failures", "attempts")),
    "corrupt_twice": (2, [("corrupt", 1, 0, 0.25, 2)], "raise", 1.5, ("retries", "integrity_failures", "attempts")),
    "flaky": (2, [("flaky", 1, 0, 0.25, 1)], "raise", 1.5, ("retries", "kv_timeouts", "integrity_failures")),
    "straggler": (2, [("straggler", 1, 0, 0.3, 1)], "raise", 1.5, ("retries", "integrity_failures")),
    "delay": (2, [("delay", 1, 0, 0.2, 1)], "raise", 1.5, ("retries", "integrity_failures")),
    "drop_partial": (3, [("drop", 1, 0, 0.25, 1)], "partial", 1.0, ("integrity_failures",)),
    "drop_raise": (2, [("drop", 1, 0, 0.25, 1)], "raise", 0.8, ()),
    "corrupt_forever": (2, [("corrupt", 1, 0, 0.25, 99)], "raise", 0.8, ()),
}


def _specs(pkg, plan):
    return [pkg.resilience.FaultSpec(kind, rank=r, epoch=e, seconds=s, times=t) for kind, r, e, s, t in plan]


def _values(pkg, payloads):
    g = _groups(pkg)
    return [None if p is None else np.asarray(g._decode(p)).tolist() for p in payloads]


def _exchange(pkg, scenario, client_for=None):
    """Each rank's (payload values or the error's type, report) for one
    scenario: an in-memory store of ``pkg``, or ``client_for(rank, plan)``."""
    world, plan, policy, timeout_s, _ = SCENARIOS[scenario]
    g = _groups(pkg)
    group = _group(pkg, world, _name(f"x{scenario}"), timeout_s)
    reports = {r: pkg.resilience.new_sync_stats() for r in range(world)}

    def peer(rank):
        try:
            payloads = g._exchange_bytes(g._encode(np.arange(4) + 100 * rank), group, rank, policy=policy, report=reports[rank])
            return _values(pkg, payloads)
        except pkg.SyncError as err:
            return type(err).__name__

    if client_for is None:
        store = pkg.resilience.InMemoryKVStore(_specs(pkg, plan))
        out = pkg.resilience.run_as_peers(world, peer, store=store, timeout_s=30)
    else:
        faults_plan = pkg.resilience.FaultPlan(_specs(pkg, plan))
        out = _threads(world, lambda r: _in_world(pkg, r, world, client_for(r, faults_plan), lambda: peer(r)))
    return out, reports


def _in_world(pkg, rank, world, client, fn):
    with pkg.resilience.simulated_world(rank, world, client):
        return fn()


def _threads(world, fn, timeout_s=30):
    results, errors = {}, {}

    def run(rank):
        try:
            results[rank] = fn(rank)
        except BaseException as err:  # noqa: BLE001 - re-raised below
            errors[rank] = err

    threads = [threading.Thread(target=run, args=(r,), daemon=True) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s)
    assert not any(t.is_alive() for t in threads), "a peer hung past its deadline"
    if errors:
        raise errors[sorted(errors)[0]]
    return results


def _fixed(reports, keys):
    return {r: {k: reports[r][k] for k in ("missing_ranks", *keys)} for r in reports}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_exchange_under_fault_plans_equals_jax(scenario):
    mj, mt = _pkgs()
    keys = SCENARIOS[scenario][-1]
    start = time.monotonic()
    got, got_reports = _exchange(mt, scenario)
    assert time.monotonic() - start < 3 * SCENARIOS[scenario][3] + 1  # bounded by the deadline
    want, want_reports = _exchange(mj, scenario)
    assert got == want
    if scenario in ("drop_raise", "corrupt_forever"):
        assert got[0] == "SyncTimeoutError"
        return
    assert _fixed(got_reports, keys) == _fixed(want_reports, keys)
    for r in got_reports:
        assert got_reports[r]["bytes_sent"] == want_reports[r]["bytes_sent"]
        assert got_reports[r]["bytes_received"] == want_reports[r]["bytes_received"]
    if scenario == "drop_partial":
        assert got[0] == [[0, 1, 2, 3], None, [200, 201, 202, 203]]
        assert got_reports[0]["missing_ranks"] == [1] and got_reports[1]["missing_ranks"] == []
    if scenario == "corrupt_twice":
        assert got_reports[0]["retries"] == 2 and got_reports[0]["integrity_failures"] == 2


STORE_SCENARIOS = ("clean", "corrupt_twice", "flaky", "straggler", "delay", "drop_partial", "drop_raise")


@pytest.mark.parametrize("scenario", STORE_SCENARIOS)
def test_store_client_over_a_hash_store_runs_the_same_exchanges(scenario):
    """The four-call protocol over a ``torch.distributed`` store, the plan
    in a ``FaultyClient`` per rank, gives what the in-memory store gives."""
    import torch.distributed as dist

    mj, mt = _pkgs()
    world = SCENARIOS[scenario][0]
    hash_store = dist.HashStore()
    clients = {}

    def client_for(rank, plan):
        inner = clients.setdefault(rank, mt.parallel.StoreClient(hash_store, rank, world))
        return mt.resilience.FaultyClient(inner, plan)

    got, got_reports = _exchange(mt, scenario, client_for)
    want, want_reports = _exchange(mt, scenario)
    assert got == want
    keys = SCENARIOS[scenario][-1]
    if scenario != "drop_raise":
        assert _fixed(got_reports, keys) == _fixed(want_reports, keys)
    if scenario == "clean":
        # a second exchange passes its barrier and removes the first one's arrival keys
        again, _ = _exchange(mt, "clean", client_for)
        assert again == want


def test_store_client_reads_never_block_on_a_deleted_key_and_the_barrier_names_the_missing():
    import torch.distributed as dist

    _, mt = _pkgs()
    store = dist.HashStore()
    a, b = mt.parallel.StoreClient(store, 0, 2), mt.parallel.StoreClient(store, 1, 2)
    a.key_value_set_bytes("k", b"MTpayload")
    assert b.blocking_key_value_get_bytes("k", 100) == b"MTpayload"
    a.key_value_delete("k")
    start = time.monotonic()
    with pytest.raises(TimeoutError, match="DEADLINE_EXCEEDED"):
        b.blocking_key_value_get_bytes("k", 200)
    with pytest.raises(TimeoutError, match=r"missing ranks \[1\]"):
        a.wait_at_barrier("metrics_tpu/pg/s/0/done", 150, process_ids=[0, 1])
    assert time.monotonic() - start < 2.0
    barrier = threading.Thread(target=b.wait_at_barrier, args=("metrics_tpu/pg/s/1/done", 2000, [0, 1]))
    barrier.start()
    a.wait_at_barrier("metrics_tpu/pg/s/1/done", 2000, process_ids=[0, 1])
    barrier.join(5)
    # rank 0 passed a later barrier of the scope: its earlier arrival keys are gone
    assert not store.check(["metrics_tpu/pg/s/0/done/0"]) and store.check(["metrics_tpu/pg/s/1/done/0"])
    assert mt.parallel.groups._is_transient_kv_error(dist.DistStoreError("Wait timeout"))


def test_the_default_store_backs_the_world_client():
    """``_kv_client`` outside a world names ``init_process_group``; inside
    one it is a ``StoreClient`` over the default group's store (read through
    ``distributed_c10d._get_default_store``)."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d

    _, mt = _pkgs()
    g = mt.parallel.groups
    with pytest.raises(RuntimeError, match="init_process_group"):
        g._kv_client()
    assert hasattr(distributed_c10d, "_get_default_store")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        client = g._kv_client()
        assert isinstance(client, mt.parallel.StoreClient) and g._kv_client() is client
        client.key_value_set_bytes("metrics_tpu/pg/pin/0/0", b"MT1")
        assert g._default_store().check(["metrics_tpu/pg/pin/0/0"])
        client.wait_at_barrier("metrics_tpu/pg/pin/0/done", 1000, process_ids=[0])
        # a group of the one process is a no-op sync, as in the JAX package
        assert torch.equal(g.gather_group_arrays(torch.arange(3), mt.parallel.new_group([0]))[0], torch.arange(3))
    finally:
        dist.destroy_process_group()


def test_transient_classifier_equals_jax():
    mj, mt = _pkgs()
    errors = (
        TimeoutError("x"), ConnectionError("peer hung up"), ConnectionResetError("reset"), OSError(104, "reset"),
        BrokenPipeError("pipe"), RuntimeError("DEADLINE_EXCEEDED: kv get"), RuntimeError("server UNAVAILABLE"),
        RuntimeError("invalid argument"), ValueError("bad payload"),
    )
    for err in errors:
        assert mt.parallel.groups._is_transient_kv_error(err) == mj.parallel.groups._is_transient_kv_error(err), err
    for transient in (True, False):
        assert mt.parallel.groups._is_transient_kv_error(mt.SyncIntegrityError("t", transient=transient)) is transient
    assert mt.parallel.groups._is_transient_kv_error(mt.InjectedFaultError("UNAVAILABLE: injected"))


def test_publish_and_cleanup_failures_are_classified():
    _, mt = _pkgs()
    g = mt.parallel.groups

    class Down:
        def key_value_set_bytes(self, key, value):
            raise RuntimeError("UNAVAILABLE: store unreachable")

    group = _group(mt, 2, _name("down"), 0.5)
    with mt.resilience.simulated_world(0, 2, Down()):
        with pytest.raises(mt.SyncError, match="KV publish failed"):
            g._exchange_bytes(g._encode(np.arange(2)), group, 0)

    store = mt.resilience.InMemoryKVStore()

    class NoDelete:
        def __init__(self, inner):
            self._inner = inner

        def key_value_delete(self, key):
            raise RuntimeError("UNAVAILABLE: gone during cleanup")

        def __getattr__(self, name):
            return getattr(self._inner, name)

    group = _group(mt, 2, _name("nodel"), 1.0)
    out = _threads(2, lambda r: _in_world(mt, r, 2, NoDelete(store.client(r)), lambda: g._exchange_bytes(g._encode(np.arange(2) + r), group, r)))
    assert g._decode(out[0][1]).tolist() == [1, 2]


# ---------------------------------------------------------------------------
# a JAX peer and port peers in one group
# ---------------------------------------------------------------------------
def _mixed(world, jax_ranks, fn_for, store=None, speaks=None):
    """Run ``fn_for(pkg, rank)()`` on every rank, the ranks in ``jax_ranks``
    as JAX package peers and the rest as port peers, on one shared store;
    ``speaks`` maps ranks to the wire versions they are pinned to."""
    mj, mt = _pkgs()
    store = store if store is not None else mt.resilience.InMemoryKVStore()
    speaks = speaks or {}

    def run(rank):
        pkg = mj if rank in jax_ranks else mt
        fn = fn_for(pkg, rank)
        if rank in speaks:
            inner = fn

            def fn():
                with _groups(pkg).speaking(*speaks[rank]):
                    return inner()

        return _in_world(pkg, rank, world, store.client(rank), fn)

    return _threads(world, run)


@pytest.mark.parametrize("precision", [None, "bf16", "int8"])
def test_a_jax_peer_and_port_peers_share_one_group(precision):
    import jax.numpy as jnp

    mj, mt = _pkgs()
    name = _name("mix")
    data = {r: (np.random.default_rng(r).normal(size=(300 + 10 * r,)) * 4).astype(np.float32) for r in range(3)}

    def fn_for(pkg, rank):
        group = _group(pkg, 3, name, 2.0)
        x = jnp.asarray(data[rank]) if pkg is mj else torch.from_numpy(data[rank])
        return lambda: [np.asarray(v) for v in _groups(pkg).gather_group_arrays(x, group, precision=precision)]

    out = _mixed(3, {0}, fn_for)
    for r in range(3):
        want = data[r] if precision is None else _round_trip(data[r], precision)
        for rank in range(3):
            np.testing.assert_array_equal(out[rank][r], want)


def _round_trip(arr, codec):
    from metrics_tpu.parallel import quantize as jq

    q, scales, _ = jq.quantize_array(arr, codec)
    return jq.dequantize_array(q, scales, codec, arr.dtype, arr.shape)


def test_mixed_group_metric_sync_and_a_v1_jax_peer():
    """``ConfusionMatrix`` synced across a JAX peer and two port peers equals
    the serial confusion matrix; then the JAX peer speaks v1 only, and a
    tagged tree from the port peers travels exact."""
    import jax.numpy as jnp

    mj, mt = _pkgs()
    rng = np.random.default_rng(7)
    preds, target = rng.integers(0, 4, (3, 40)), rng.integers(0, 4, (3, 40))
    name = _name("mixcm")

    def fn_for(pkg, rank):
        group = _group(pkg, 3, name, 2.0)
        kw = {} if pkg is mj else {"device": "cpu"}
        m = pkg.ConfusionMatrix(num_classes=4, process_group=group, **kw)
        if pkg is mj:
            m.update(jnp.asarray(preds[rank]), jnp.asarray(target[rank]))
        else:
            m.update(torch.from_numpy(preds[rank]), torch.from_numpy(target[rank]))
        return lambda: np.asarray(m.compute())

    out = _mixed(3, {0}, fn_for)
    serial = np.zeros((4, 4), np.int64)
    np.add.at(serial, (target.ravel(), preds.ravel()), 1)
    for r in range(3):
        np.testing.assert_array_equal(out[r], serial)

    scores = {r: (rng.normal(size=(260,)) * 3).astype(np.float32) for r in range(3)}
    name = _name("mixv1")
    mt.parallel.reset_negotiation_stats()

    def tree_for(pkg, rank):
        group = _group(pkg, 3, name, 2.0)
        x = jnp.asarray(scores[rank]) if pkg is mj else torch.from_numpy(scores[rank])
        tree = {"scores": x, "n": (jnp.asarray if pkg is mj else torch.as_tensor)(np.int64(rank))}
        return lambda: [{k: np.asarray(v) for k, v in t.items()} for t in _groups(pkg).gather_group_pytrees(tree, group, precisions={"scores": "int8"})]

    out = _mixed(3, {0}, tree_for, speaks={0: (1,)})
    for rank in range(3):
        for r in range(3):
            np.testing.assert_array_equal(out[rank][r]["scores"], scores[r])  # exact: the group settled on v1
            assert int(out[rank][r]["n"]) == r
    nego = mt.parallel.negotiation_stats()
    assert nego == {"negotiations": 2, "capped": 2, "fallback_exact": 2}  # the two port peers


def test_speaking_v1_caps_the_group_as_in_jax():
    mj, mt = _pkgs()
    data = {r: (np.arange(300, dtype=np.float32) + r) / 7 for r in range(3)}
    results = {}
    for pkg in (mt, mj):
        g = _groups(pkg)
        g.reset_negotiation_stats()
        name = _name("v1")
        group = _group(pkg, 3, name, 2.0)
        events = []

        def peer(rank, pkg=pkg, g=g, group=group):
            x = torch.from_numpy(data[rank]) if pkg is mt else data[rank]
            if rank == 2:
                with g.speaking(1):
                    return [np.asarray(v) for v in g.gather_group_arrays(x, group, precision="bf16")]
            return [np.asarray(v) for v in g.gather_group_arrays(x, group, precision="bf16")]

        with pkg.obs.capture() as events:
            out = pkg.resilience.run_as_peers(3, peer, timeout_s=30)
        results[pkg.__name__] = (out, g.negotiation_stats(), sorted(e.data["rank"] for e in events if e.kind == "compat"))
        for rank in range(3):
            for r in range(3):
                np.testing.assert_array_equal(out[rank][r], data[r])
    assert results["metrics_tpu_torch"][1] == results["metrics_tpu"][1] == {"negotiations": 3, "capped": 2, "fallback_exact": 3}
    assert results["metrics_tpu_torch"][2] == results["metrics_tpu"][2] == [0, 1]
    with pytest.raises(ValueError, match="non-empty subset"):
        with mt.parallel.speaking(3):
            pass


# ---------------------------------------------------------------------------
# integrity digests
# ---------------------------------------------------------------------------
def _digest_cases():
    rng = np.random.default_rng(11)
    cases = {
        "float16": rng.normal(size=(4, 3)).astype(np.float16),
        "float32": rng.normal(size=(17,)).astype(np.float32),
        "float64": rng.normal(size=(2, 5)),
        "int8": rng.integers(-100, 100, 9).astype(np.int8),
        "int16": rng.integers(-1000, 1000, 9).astype(np.int16),
        "int32": rng.integers(-9, 9, (3, 3)).astype(np.int32),
        "int64": rng.integers(-(2**40), 2**40, 7),
        "uint8": np.arange(13, dtype=np.uint8),
        "bool": rng.random(10) > 0.5,
        "zero_dim": np.asarray(2.5, np.float32),
        "empty": np.zeros((0, 3), np.int64),
    }
    return cases


@pytest.mark.parametrize("case", sorted(_digest_cases()) + ["bfloat16", "big_endian"])
def test_leaf_digests_equal_jax_for_every_dtype(case):
    import jax.numpy as jnp

    mj, mt = _pkgs()
    pi, ji = mt.resilience.integrity, mj.resilience.integrity
    if case == "bfloat16":
        values = np.random.default_rng(3).normal(size=(6, 2)).astype(np.float32)
        want = ji.leaf_digest(np.asarray(jnp.asarray(values, dtype=jnp.bfloat16)))
        assert pi.leaf_digest(torch.from_numpy(values).to(torch.bfloat16)) == want
        return
    if case == "big_endian":
        arr = np.arange(6, dtype=">i4").reshape(2, 3)
        assert pi.leaf_digest(arr) == ji.leaf_digest(arr) == ji.leaf_digest(arr.astype("<i4"))
        return
    arr = _digest_cases()[case]
    assert pi.leaf_digest(torch.from_numpy(np.array(arr))) == ji.leaf_digest(arr)
    assert pi.leaf_digest(arr) == ji.leaf_digest(jnp.asarray(arr)) or arr.dtype == np.float16
    assert pi.fold_digest(arr.tobytes()) == ji.fold_digest(arr.tobytes())


def test_state_digest_and_verify_tree_equal_jax():
    mj, mt = _pkgs()
    pi, ji = mt.resilience.integrity, mj.resilience.integrity
    tree = {"tp": np.arange(5, dtype=np.int64), "score": np.float32(1.5) * np.ones(3, np.float32), "n": np.asarray(3)}
    ttree = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    sealed = ji.state_digest(tree)
    assert pi.state_digest(ttree) == sealed and list(sealed) == ["n", "score", "tp"]
    pi.reset_integrity_stats()
    with mt.obs.capture() as events:
        pi.verify_tree(ttree, sealed)
        pi.verify_tree(ttree, None)
        flipped = dict(ttree, tp=ttree["tp"].clone())
        flipped["tp"][2] ^= 1
        with pytest.raises(mt.StateIntegrityError, match="'tp'") as exc:
            pi.verify_tree(flipped, sealed, bank="b0", tenant=7, context=" (test)")
        with pytest.raises(mt.StateIntegrityError, match="'score'"):
            pi.verify_tree({"n": ttree["n"], "tp": ttree["tp"]}, sealed)
    assert (exc.value.leaf, exc.value.bank, exc.value.tenant) == ("tp", "b0", 7)
    stats = pi.integrity_stats()
    assert stats["attests_verified"] == 1 and stats["attest_failures"] == 2
    assert set(stats) == set(ji.integrity_stats())
    attests = [e for e in events if e.kind == "attest"]
    assert [e.data["ok"] for e in attests] == [True, False, False] and attests[1].data["leaf"] == "tp"
    assert mt.obs.snapshot()["integrity"] == stats
    pi.reset_integrity_stats()


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------
class _Router:
    def __init__(self):
        self.max_delay_s = 0.05


class _Bank:
    def __init__(self):
        self.checkpoint_cadence = 2
        self._flush_ms_ewma = 12.0

    def set_checkpoint_cadence(self, n):
        self.checkpoint_cadence = n


class _Worker:
    def __init__(self):
        self.alive, self.router, self.bank = True, _Router(), _Bank()


class _Fleet:
    """The surface the controller reads of a fleet: queued requests, owners,
    workers with a router and a bank."""

    name = "fake"

    def __init__(self):
        self._workers = {0: _Worker(), 1: _Worker()}
        self.queued = []

    def pending_requests(self):
        return len(self.queued)

    def owner_of(self, tenant):
        return len(str(tenant)) % 2

    def submit(self, tenant, *args):
        self.queued.append((tenant, args))
        return f"req{len(self.queued)}"

    def flush(self):
        self.queued.clear()


def _trace(pkg):
    """One scripted trace of submits, ticks and flushes on an injected
    clock; every decision and the controller's summary."""
    clock = [0.0]
    fleet = _Fleet()
    ctrl = pkg.resilience.AdmissionController(
        fleet, tenant_rate=2.0, tenant_burst=3.0, max_inflight=5, retry_rate=0.5, retry_burst=1.0,
        brownout_after=2, brownout_recover_after=2, brownout_stretch=4.0, name="ctrl", clock=lambda: clock[0],
    )
    decisions = []
    steps = [
        ("submit", "a", {}), ("submit", "a", {}), ("submit", "a", {}), ("submit", "a", {}), ("tick",),
        ("submit", "b", {"retry": True}), ("submit", "b", {"retry": True}), ("submit", "c", {}), ("submit", "d", {}),
        ("tick",), ("flush",), ("advance", 1.0), ("submit", "a", {"deadline_s": 0.01}),
        ("submit", "a", {"deadline_s": 5.0}), ("flush",), ("tick",), ("tick",), ("advance", 3.0),
        ("submit", "a", {"retry": True}), ("tick",),
    ]
    for step in steps:
        if step[0] == "submit":
            try:
                decisions.append(("admit", ctrl.submit(step[1], 1.0, **step[2])))
            except pkg.OverloadError as err:
                decisions.append(("shed", err.reason, err.tenant))
        elif step[0] == "tick":
            decisions.append(("tick", ctrl.tick(), fleet._workers[0].router.max_delay_s, fleet._workers[0].bank.checkpoint_cadence))
        elif step[0] == "advance":
            clock[0] += step[1]
        else:
            fleet.flush()
    return decisions, ctrl.summary(), ctrl


def test_admission_control_takes_the_jax_decisions_on_one_trace():
    mj, mt = _pkgs()
    with mt.obs.capture() as events:
        got, got_summary, ctrl = _trace(mt)
    want, want_summary, _ = _trace(mj)
    assert got == want and got_summary == want_summary
    assert {d[1] for d in got if d[0] == "shed"} == {"tenant_quota", "inflight", "retry_budget", "deadline"}
    assert any(d[0] == "tick" and d[1] for d in got)  # brownout entered, and left
    assert got_summary["brownouts_entered"] == 1 and got_summary["brownouts_exited"] == 1
    assert [e.data["event"] for e in events if e.kind == "guard"] == ["brownout_enter", "brownout_exit"]
    assert {e.data["reason"] for e in events if e.kind == "shed"} == {"tenant_quota", "inflight", "retry_budget", "deadline"}
    summary = mt.resilience.overload_summary()  # over the live controllers
    assert summary["controllers"]["ctrl"] == ctrl.summary() and summary["admitted"] >= got_summary["admitted"]
    assert mt.resilience.overload.SHED_REASONS == mj.resilience.overload.SHED_REASONS
    bucket = mt.resilience.TokenBucket(rate=2.0, burst=3.0, clock=lambda: 0.0)
    assert [bucket.try_take() for _ in range(4)] == [True, True, True, False]


# ---------------------------------------------------------------------------
# metrics under on_sync_error, against the JAX package
# ---------------------------------------------------------------------------
def _tagged(pkg):
    xp = torch if pkg.__name__ == "metrics_tpu_torch" else __import__("jax.numpy", fromlist=["numpy"])

    class Tagged(pkg.Metric):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.add_state("total", default=np.zeros(300, np.float32), dist_reduce_fx="sum", sync_precision="int8")
            self.add_state("scores", default=[], dist_reduce_fx="cat", sync_precision="bf16")
            self.add_state("n", default=np.zeros((), np.int64), dist_reduce_fx="sum", sync_precision="int8")

        def update(self, x):
            self.total = self.total + x.sum(0)
            self.scores.append(x[:, 0])
            self.n = self.n + x.shape[0]

        def compute(self):
            scores = self.scores if isinstance(self.scores, list) else [self.scores]
            return {"total": self.total, "scores": xp.concatenate(scores) if scores else xp.zeros(0), "n": self.n}

    return Tagged


METRIC_CASES = {
    "accuracy": (lambda pkg, **kw: pkg.Accuracy(num_classes=5, **kw), "labels"),
    "confmat": (lambda pkg, **kw: pkg.ConfusionMatrix(num_classes=5, **kw), "labels"),
    "tagged": (lambda pkg, **kw: _tagged(pkg)(**kw), "floats"),
}
REPORT_KEYS = (
    "syncs", "missing_ranks", "degraded_local", "degraded_partial", "last_sync_outcome", "integrity_failures",
    "bytes_raw", "bytes_encoded", "bytes_raw_quantized", "bytes_encoded_quantized", "codec_counts", "on_sync_error",
)


def _metric_run(pkg, case, policy, drop: bool):
    import jax.numpy as jnp

    build, kind = METRIC_CASES[case]
    rng = np.random.default_rng(5)
    world = 3
    group = _group(pkg, world, _name(f"m{case}{policy}"), 1.0)
    metrics = []
    for rank in range(world):
        kw = {} if pkg.__name__ == "metrics_tpu" else {"device": "cpu"}
        m = build(pkg, process_group=group, on_sync_error=policy, **kw)
        if kind == "labels":
            preds, target = rng.integers(0, 5, 24), rng.integers(0, 5, 24)
            args = (preds, target)
        else:
            args = ((rng.normal(size=(4 + rank, 300)) * 3).astype(np.float32),)
        conv = jnp.asarray if pkg.__name__ == "metrics_tpu" else torch.from_numpy
        m.update(*[conv(a) for a in args])
        metrics.append(m)
    store = pkg.resilience.InMemoryKVStore([pkg.resilience.FaultSpec("drop", rank=1, epoch=0)] if drop else [])

    def peer(rank):
        try:
            value = metrics[rank].compute()
        except pkg.SyncError as err:
            return type(err).__name__
        if isinstance(value, dict):
            return {k: np.asarray(v) for k, v in value.items()}
        return np.asarray(value)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        out = pkg.resilience.run_as_peers(world, peer, store=store, timeout_s=30)
    return out, [{k: m.sync_report()[k] for k in REPORT_KEYS} for m in metrics]


def _close(got, want):
    if isinstance(want, str) or isinstance(got, str):
        assert got == want
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k])
    elif np.issubdtype(np.asarray(want).dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("policy", ["raise", "local", "partial"])
@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_metrics_under_on_sync_error_equal_jax(case, policy):
    mj, mt = _pkgs()
    got, got_reports = _metric_run(mt, case, policy, drop=True)
    want, want_reports = _metric_run(mj, case, policy, drop=True)
    for rank in range(3):
        _close(got[rank], want[rank])
    assert got_reports == want_reports
    if policy == "partial":
        assert got_reports[0]["missing_ranks"] == [1] and got_reports[0]["last_sync_outcome"] == "partial"
        assert got_reports[0]["degraded_partial"] == 1 and got_reports[1]["last_sync_outcome"] == "complete"
    if policy == "raise":
        assert got[0] == "SyncTimeoutError"


@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_healthy_group_sync_equals_jax(case):
    mj, mt = _pkgs()
    got, got_reports = _metric_run(mt, case, "raise", drop=False)
    want, want_reports = _metric_run(mj, case, "raise", drop=False)
    for rank in range(3):
        _close(got[rank], want[rank])
        _close(got[rank], got[0])
    assert got_reports == want_reports and got_reports[0]["last_sync_outcome"] == "complete"


def test_partial_sync_emits_the_jax_events_and_pickles_the_group():
    import pickle

    from metrics_tpu_torch.utils.exceptions import MetricsUserError

    _, mt = _pkgs()
    group = _group(mt, 3, _name("ev"), 1.0)
    metrics = [mt.SumMetric(process_group=group, on_sync_error="partial", device="cpu") for _ in range(3)]
    for rank, m in enumerate(metrics):
        m.update(torch.tensor(float(10**rank)))
    store = mt.resilience.InMemoryKVStore([mt.resilience.FaultSpec("drop", rank=1, epoch=0)])
    with warnings.catch_warnings(), mt.obs.capture() as events:
        warnings.simplefilter("ignore", UserWarning)
        out = mt.resilience.run_as_peers(3, lambda r: float(metrics[r].compute()), store=store, timeout_s=30)
    assert out == {0: 101.0, 1: 111.0, 2: 101.0}
    degrade = [e for e in events if e.kind == "sync_degrade" and e.data.get("outcome") == "partial"]
    assert sorted(e.data["missing_ranks"] for e in degrade) == [[1], [1]]
    kinds = {e.kind for e in events}
    assert {"sync_attempt", "sync_retry"} <= kinds
    assert float(metrics[0].value) == 1.0  # unsynced after compute()
    copy = pickle.loads(pickle.dumps(metrics[0]))
    assert copy.process_group == group and copy.sync_report()["missing_ranks"] == [1]
    # a world-spanning gather has no simulated backend: it refuses loudly
    lone = mt.SumMetric(device="cpu")
    lone.update(torch.tensor(1.0))

    def peer(rank):
        if rank == 0:
            with pytest.raises(MetricsUserError, match="simulated world"):
                lone.compute()
        return rank

    mt.resilience.run_as_peers(2, peer, timeout_s=30)
    with pytest.raises(ValueError, match="not a member"):
        mt.resilience.run_as_peers(2, lambda r: _groups(mt).gather_group_arrays(torch.zeros(1), mt.parallel.new_group([1], name=_name("nm"))) if r == 0 else None)


def test_process_group_accepts_both_kinds_and_the_schema_registry_walks_upcasts():
    mj, mt = _pkgs()
    mt.Accuracy(process_group=mt.parallel.new_group([0, 1]), device="cpu")
    with pytest.raises(ValueError, match="ProcessGroup"):
        mt.Accuracy(process_group="world", device="cpu")
    schema = mt.resilience.schema
    family = _name("fam")
    schema.register_schema(family, 1, lambda p, c: {"v": 1, "x": p["x"]}, upcast=lambda o: {**o, "v": 2}, prober=lambda p: p["v"])
    schema.register_schema(family, 2, lambda p, c: dict(p))
    assert schema.decode_any(family, {"v": 1, "x": 5}) == {"v": 2, "x": 5}
    assert schema.current_version(family) == 2 and schema.registered_versions(family) == [1, 2]
    with pytest.raises(mt.SchemaVersionError, match="NEWER build") as exc:
        schema.decode_any(family, {"v": 3})
    assert (exc.value.family, exc.value.version, exc.value.current) == (family, 3, 2)
    assert schema.compat_stats()[family] == {"versions": [1, 2], "current": 2, "decodes": 1, "upcasts": 1, "rejects": 1}
    assert json.dumps(mt.obs.snapshot()["compat"])  # plain data
    assert set(mt.obs.snapshot()["compat"]) == set(mj.obs.snapshot()["compat"]) == {"families", "wire_negotiation"}

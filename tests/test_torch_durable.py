"""The port's durable state plane (``metrics_tpu_torch.serving.store`` and
``MetricBank``'s journal, checkpoints and ``recover``) against
``metrics_tpu.serving`` on the same numpy inputs.

Each case of ``tests/serving/test_durable_bank.py`` runs as a scenario on
both packages (the harness of ``tests/test_torch_serving.py``), each in its
own ``tmp_path`` directory; the observations must agree, and for these
integer-state templates under the tests' x64 the journal records and the
payload blobs must be the same bytes. Besides:

* a ``DiskStore`` written by either package ``recover()``s in the other,
  bit for bit, both ways;
* the golden ``tests/compat/golden/journal_v{1,2,99}.bin`` and
  ``payload_v{1,2,99}.bin`` (opened read-only): v1 and v2 decode to the JAX
  package's records and trees, v99 raises ``SchemaVersionError``;
* a child process that imports only torch and the port is ``SIGKILL``ed
  mid-traffic and this process recovers every acknowledged tenant.
"""
import glob
import json
import os
import signal
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_serving import NUM_CLASSES, REPO, SIDES, Side, host, req, run_both, same, states_equal_solo

GOLDEN = os.path.join(REPO, "tests", "compat", "golden")


def acc(S):
    return S.m("Accuracy", num_classes=NUM_CLASSES)


def disk(S, tmp, name="store"):
    return S.serving.DiskStore(str(tmp / S.name / name))


def equals_solo(bank, tenant, solo):
    states_equal_solo(bank, tenant, solo)
    np.testing.assert_array_equal(host(bank.compute(tenant)), host(solo.compute()))


def store_bytes(store, journals):
    """Every blob and journal frame of a store, the bytes both packages must
    write alike."""
    if hasattr(store, "_blobs"):
        blobs = dict(store._blobs)
    else:
        blobs = {}
        for path in sorted(glob.glob(os.path.join(store._blob_dir, "*.bin"))):
            with open(path, "rb") as f:
                blobs[os.path.basename(path)] = f.read()
    return {"blobs": blobs, "journals": {j: store.journal_frames(j) for j in journals}}


def recovered_obs(bank):
    tenants = sorted(bank.tenants + bank.spilled_tenants, key=str)
    return {
        "tenants": [str(t) for t in tenants],
        "state": {str(t): host(bank.tenant_state(t)) for t in tenants},
        "counts": {str(t): bank.update_count(t) for t in tenants},
    }


def serve(S, bank, tenants, n_steps, solos=None):
    for step in range(n_steps):
        for i, t in enumerate(tenants):
            r = req(S, 1000 * step + i)
            bank.update(t, *r)
            if solos is not None:
                solos[t].update(*r)


# ---------------------------------------------------------------------------
# the store protocol
# ---------------------------------------------------------------------------
def any_store(S, tmp, kind):
    return S.serving.MemoryStore() if kind == "memory" else disk(S, tmp)


def sc_blob_round_trip(S, tmp, kind):
    store = any_store(S, tmp, kind)
    assert not store.exists("k")
    store.put("k", b"payload-1")
    assert store.exists("k") and store.get("k") == b"payload-1"
    store.put("k", b"payload-2")
    assert store.get("k") == b"payload-2"
    store.delete("k")
    assert not store.exists("k")
    store.delete("k")
    with pytest.raises(KeyError):
        store.get("k")
    return store.persistent


def sc_journal_round_trip(S, tmp, kind):
    store = any_store(S, tmp, kind)
    assert store.journal_frames("j") == []
    records = [S.store.seal_record({"op": "admit", "i": i}) for i in range(5)]
    for r in records:
        store.append_journal("j", r)
    assert store.journal_frames("j") == records
    decoded, torn = S.store.read_journal(store, "j")
    assert torn == 0 and [r["i"] for r in decoded] == list(range(5))
    store.rewrite_journal("j", records[:2])
    assert store.journal_frames("j") == records[:2]
    return {"records": records, "decoded": decoded}


def sc_torn_tail_dropped(S, tmp):
    store = disk(S, tmp)
    good = [S.store.seal_record({"op": "admit", "i": i}) for i in range(3)]
    for r in good:
        store.append_journal("j", r)
    path = store._journal_path("j")
    with open(path, "ab") as f:
        f.write(struct.pack(">I", 1 << 20) + b"short")
    assert store.journal_frames("j") == good
    with open(path, "ab") as f:
        f.write(b"\x00\x01")
    assert store.journal_frames("j") == good
    return good


def sc_crc_corrupted(S, tmp, kind):
    store = any_store(S, tmp, kind)
    good = S.store.seal_record({"op": "admit", "t": ["s", "a"]})
    bad = bytearray(S.store.seal_record({"op": "admit", "t": ["s", "b"]}))
    bad[-1] ^= 0xFF
    after = S.store.seal_record({"op": "admit", "t": ["s", "c"]})
    for frame in (good, bytes(bad), after):
        store.append_journal("j", frame)
    before = S.serving.durability_stats()["torn_records"]
    records, torn = S.store.read_journal(store, "j")
    assert [r["t"][1] for r in records] == ["a"] and torn == 2
    assert S.serving.durability_stats()["torn_records"] == before + 2
    return records


def sc_tokens(S, tmp):
    tokens = []
    for tenant in ["a", 1, 0, True, False, 2.5, None]:
        token = S.store.durable_token(tenant)
        back = S.store.token_tenant(token)
        assert back == tenant and type(back) is type(tenant)
        tokens.append((token, S.store.token_key(token)))
    assert len({S.store.token_key(S.store.durable_token(t)) for t in [1, "1", True, 1.0]}) == 4
    with pytest.raises(S.exc.MetricsUserError, match="durable state plane"):
        S.store.durable_token(("tuple", "id"))
    return tokens


def sc_unjournalable_tenant(S, tmp):
    bank = S.bank(acc(S), capacity=2)
    with pytest.raises(S.exc.MetricsUserError, match="durable state plane") as err:
        bank.update(("t", 0), *req(S, 0))
    return str(err.value)


# ---------------------------------------------------------------------------
# recovery
# ---------------------------------------------------------------------------
def sc_recover_every_tenant(S, tmp):
    store = disk(S, tmp)
    tenants = [f"t{i}" for i in range(5)]
    solos = {t: acc(S) for t in tenants}
    bank = S.bank(acc(S), capacity=2, name="crashable", spill_store=store, checkpoint_every_n_flushes=1)
    serve(S, bank, tenants, 4, solos)
    assert bank.stats["spills"] > 0 and bank.stats["checkpoints"] > 0
    written = store_bytes(store, ["crashable"])
    del bank
    with S.obs.capture() as events:
        recovered = S.serving.MetricBank.recover(acc(S), 2, store, name="crashable")
    assert sorted(recovered.spilled_tenants) == tenants
    for t in tenants:
        equals_solo(recovered, t, solos[t])
    r = req(S, 99)
    recovered.update("t0", *r)
    solos["t0"].update(*r)
    equals_solo(recovered, "t0", solos["t0"])
    recover = [e.data for e in events if e.kind == "recover"]
    assert recover and recover[0]["tenants"] == 5
    return {"written": written, "recover": recover, **recovered_obs(recovered), "stats": dict(recovered.stats)}


def sc_double_recovery(S, tmp):
    store = disk(S, tmp)
    solos = {t: acc(S) for t in ["a", "b"]}
    bank = S.bank(acc(S), capacity=2, name="twice", spill_store=store, checkpoint_every_n_flushes=1)
    serve(S, bank, ["a", "b"], 3, solos)
    del bank
    first = S.serving.MetricBank.recover(acc(S), 2, store, name="twice")
    second = S.serving.MetricBank.recover(acc(S), 2, store, name="twice")
    assert sorted(first.spilled_tenants) == sorted(second.spilled_tenants) == ["a", "b"]
    for t in ["a", "b"]:
        equals_solo(second, t, solos[t])
    return {**recovered_obs(second), "journal": store.journal_frames("twice")}


def sc_recover_torn_tail(S, tmp):
    store = disk(S, tmp)
    solos = {"a": acc(S)}
    bank = S.bank(acc(S), capacity=1, name="torn", spill_store=store, checkpoint_every_n_flushes=1)
    serve(S, bank, ["a"], 3, solos)
    del bank
    with open(store._journal_path("torn"), "ab") as f:
        corrupted = bytearray(S.store.seal_record({"op": "drop", "t": ["s", "a"]}))
        corrupted[-1] ^= 0xFF
        f.write(struct.pack(">I", len(corrupted)) + bytes(corrupted))
        f.write(struct.pack(">I", 999))
    recovered = S.serving.MetricBank.recover(acc(S), 1, store, name="torn")
    assert recovered.spilled_tenants == ["a"]
    equals_solo(recovered, "a", solos["a"])
    return recovered_obs(recovered)


def sc_framing_torn_counted(S, tmp):
    store = disk(S, tmp)
    store.append_journal("j", S.store.seal_record({"op": "admit", "t": ["s", "a"]}))
    with open(store._journal_path("j"), "ab") as f:
        f.write(struct.pack(">I", 999) + b"partial")
    records, torn = S.store.read_journal(store, "j")
    assert [r["op"] for r in records] == ["admit"] and torn == 1
    before = S.serving.durability_stats()["torn_tails_truncated"]
    store2 = disk(S, tmp)
    S.store.journal_drop(store2, "j", "a")
    live, torn2 = S.store.replay_journal(store2, "j")
    assert live == {} and torn2 == 0
    assert S.serving.durability_stats()["torn_tails_truncated"] == before + 1
    return store2.journal_frames("j")


def sc_drop_dead_namespace(S, tmp):
    store = disk(S, tmp)
    bank = S.bank(acc(S), capacity=1, name="deadns", spill_store=store, checkpoint_every_n_flushes=1)
    bank.update("a", *req(S, 0))
    del bank
    with open(store._journal_path("deadns"), "ab") as f:
        f.write(struct.pack(">I", 999))
    fresh = disk(S, tmp)
    payloads = S.store.durable_tenant_payloads(fresh, "deadns")
    assert "a" in payloads
    S.store.journal_drop(fresh, "deadns", "a")
    assert S.store.durable_tenant_payloads(fresh, "deadns") == {}
    return payloads


def sc_async_fluctuating(S, tmp):
    store = disk(S, tmp)
    tenants = ["a", "b", "c"]
    solos = {t: acc(S) for t in tenants}
    bank = S.bank(acc(S), capacity=4, name="fluct", spill_store=store, checkpoint_async=True)
    for i, t in enumerate(tenants):
        r = req(S, i)
        bank.update(t, *r)
        solos[t].update(*r)
    bank.checkpoint()
    r = req(S, 9)
    bank.update("a", *r)
    solos["a"].update(*r)
    bank.checkpoint()
    bank.checkpoint()
    stats = dict(bank.stats)
    del bank
    recovered = S.serving.MetricBank.recover(acc(S), 4, store, name="fluct")
    for t in tenants:
        equals_solo(recovered, t, solos[t])
    return {"stats": stats, **recovered_obs(recovered)}


def sc_recover_rewrites_torn(S, tmp):
    store = disk(S, tmp)
    bank = S.bank(acc(S), capacity=1, name="rewound", spill_store=store, checkpoint_every_n_flushes=1)
    bank.update("a", *req(S, 0))
    del bank
    with open(store._journal_path("rewound"), "ab") as f:
        f.write(struct.pack(">I", 999))
    recovered = S.serving.MetricBank.recover(acc(S), 1, store, name="rewound", checkpoint_every_n_flushes=1)
    assert recovered.spilled_tenants == ["a"]
    recovered.evict("a", spill=False)
    solo_b = acc(S)
    r = req(S, 5)
    recovered.update("b", *r)
    solo_b.update(*r)
    del recovered
    again = S.serving.MetricBank.recover(acc(S), 1, store, name="rewound")
    assert sorted(again.tenants + again.spilled_tenants) == ["b"]
    equals_solo(again, "b", solo_b)
    return recovered_obs(again)


def sc_cadence_window(S, tmp):
    store = disk(S, tmp)
    solo = acc(S)
    bank = S.bank(acc(S), capacity=1, name="window", spill_store=store)
    for step in range(2):
        r = req(S, step)
        bank.update("a", *r)
        solo.update(*r)
    assert bank.checkpoint() == 1
    bank.update("a", *req(S, 7))
    del bank
    recovered = S.serving.MetricBank.recover(acc(S), 1, store, name="window")
    equals_solo(recovered, "a", solo)
    return recovered_obs(recovered)


def sc_never_checkpointed(S, tmp):
    store = disk(S, tmp)
    bank = S.bank(acc(S), capacity=2, name="wa", spill_store=store)
    bank.admit("fresh")
    bank.update("served", *req(S, 0))
    del bank
    recovered = S.serving.MetricBank.recover(acc(S), 2, store, name="wa")
    assert sorted(recovered.spilled_tenants) == ["fresh", "served"]
    assert recovered.update_count("fresh") == 0
    for name, default in acc(S)._defaults.items():
        np.testing.assert_array_equal(host(recovered.tenant_state("fresh")[name]), host(default))
    return recovered_obs(recovered)


def sc_dropped_stay_dropped(S, tmp):
    store = disk(S, tmp)
    bank = S.bank(acc(S), capacity=2, name="drops", spill_store=store, checkpoint_every_n_flushes=1)
    bank.update("keep", *req(S, 0))
    bank.update("gone", *req(S, 1))
    bank.evict("gone", spill=False)
    del bank
    recovered = S.serving.MetricBank.recover(acc(S), 2, store, name="drops")
    assert recovered.spilled_tenants == ["keep"]
    return recovered_obs(recovered)


def sc_async_trails(S, tmp):
    store = disk(S, tmp)
    solo = acc(S)
    bank = S.bank(acc(S), capacity=1, name="lagged", spill_store=store, checkpoint_async=True)
    for step in range(2):
        r = req(S, step)
        bank.update("a", *r)
        solo.update(*r)
    assert bank.checkpoint(["a"]) == 1
    bank.update("a", *req(S, 9))
    assert bank.checkpoint(["a"]) == 1
    del bank
    recovered = S.serving.MetricBank.recover(acc(S), 1, store, name="lagged")
    equals_solo(recovered, "a", solo)
    return recovered_obs(recovered)


def sc_async_forced_seal(S, tmp):
    store = disk(S, tmp)
    solo = acc(S)
    bank = S.bank(acc(S), capacity=1, name="forced", spill_store=store, checkpoint_async=True)
    r = req(S, 0)
    bank.update("a", *r)
    solo.update(*r)
    bank.checkpoint(["a"])
    bank.checkpoint()
    del bank
    recovered = S.serving.MetricBank.recover(acc(S), 1, store, name="forced")
    equals_solo(recovered, "a", solo)
    return recovered_obs(recovered)


def sc_async_no_rollback(S, tmp):
    store = disk(S, tmp)
    solo = acc(S)
    bank = S.bank(acc(S), capacity=1, name="noroll", spill_store=store, checkpoint_async=True)
    for step in range(2):
        r = req(S, step)
        bank.update("a", *r)
        solo.update(*r)
        if step == 0:
            bank.checkpoint(["a"])
    bank.evict("a")
    bank.checkpoint()
    equals_solo(bank, "a", solo)
    del bank
    recovered = S.serving.MetricBank.recover(acc(S), 1, store, name="noroll")
    equals_solo(recovered, "a", solo)
    bank2 = S.bank(acc(S), capacity=1, name="nozombie", spill_store=store, checkpoint_async=True)
    bank2.update("z", *req(S, 2))
    bank2.checkpoint(["z"])
    bank2.evict("z", spill=False)
    bank2.checkpoint()
    del bank2
    recovered2 = S.serving.MetricBank.recover(acc(S), 1, store, name="nozombie")
    assert recovered2.spilled_tenants == [] and recovered2.tenants == []
    return {"noroll": recovered_obs(recovered), "nozombie": recovered_obs(recovered2)}


def sc_async_regen(S, tmp):
    store = disk(S, tmp)
    bank = S.bank(acc(S), capacity=1, name="regen", spill_store=store, checkpoint_async=True)
    bank.update("a", *req(S, 0))
    bank.update("a", *req(S, 1))
    bank.checkpoint(["a"])
    bank.evict("a", spill=False)
    bank.admit("a")
    solo = acc(S)
    r = req(S, 7)
    bank.update("a", *r)
    solo.update(*r)
    bank.checkpoint()
    equals_solo(bank, "a", solo)
    bank.checkpoint(["a"])
    bank.checkpoint()
    del bank
    recovered = S.serving.MetricBank.recover(acc(S), 1, store, name="regen")
    equals_solo(recovered, "a", solo)
    return recovered_obs(recovered)


def _churn(S, tmp, name, cycles, cadence):
    store = disk(S, tmp)
    bank = S.bank(acc(S), capacity=1, name=name, spill_store=store, checkpoint_every_n_flushes=cadence)
    before = S.serving.durability_stats()["journal_compactions"]
    solo = acc(S)
    r = req(S, 0)
    solo.update(*r)
    bank.update("keeper", *r)
    for i in range(cycles):
        bank.update(f"ephemeral{i}", *req(S, i))
        bank.evict(f"ephemeral{i}", spill=False)
    compactions = S.serving.durability_stats()["journal_compactions"] - before
    assert compactions > 0
    live = len(bank.tenants) + len(bank.spilled_tenants)
    frames = len(store.journal_frames(name))
    assert frames <= max(256, 4 * live) + 8
    del bank
    recovered = S.serving.MetricBank.recover(acc(S), 1, store, name=name)
    assert sorted(recovered.spilled_tenants + recovered.tenants) == ["keeper"]
    equals_solo(recovered, "keeper", solo)
    return {"compactions": compactions, "frames": frames, **recovered_obs(recovered)}


def sc_journal_bounded_no_cadence(S, tmp):
    return _churn(S, tmp, "nocadence", 300, None)


def sc_compaction_bounds_churn(S, tmp):
    return _churn(S, tmp, "churny", 140, 1)


def int8_tagged_sum(S):
    """A float state tagged for int8 sync: stored payloads stay exact."""
    zeros = S.arr(np.zeros((64,), np.float32))

    class Int8TaggedSum(S.pkg.Metric):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.add_state("total", zeros, dist_reduce_fx="sum", sync_precision="int8")

        def update(self, values):
            self.total = self.total + values

        def compute(self):
            return self.total.sum()

    return Int8TaggedSum(**S.kw)


def sc_int8_tagged_exact(S, tmp):
    values = np.linspace(0.0013, 3.71, 64).astype(np.float32)
    steps = [S.arr(values), S.arr(values * np.float32(0.37))]
    solo = int8_tagged_sum(S)
    for v in steps:
        solo.update(v)
    store = disk(S, tmp)
    bank = S.bank(int8_tagged_sum(S), capacity=1, name="int8", spill_store=store, checkpoint_every_n_flushes=1)
    for v in steps:
        bank.update("a", v)
    bank.evict("a")
    equals_solo(bank, "a", solo)
    del bank
    recovered = S.serving.MetricBank.recover(int8_tagged_sum(S), 1, store, name="int8")
    equals_solo(recovered, "a", solo)
    return recovered_obs(recovered)


def sc_events_and_summary(S, tmp):
    store = disk(S, tmp)
    with S.obs.capture() as events:
        bank = S.bank(acc(S), capacity=1, name="telemetry", spill_store=store, checkpoint_every_n_flushes=1)
        bank.update("a", *req(S, 0))
        bank.update("b", *req(S, 1))
    kinds = {e.kind for e in events}
    assert {"journal", "spill_write"} <= kinds
    ops = {e.data["op"] for e in events if e.kind == "spill_write"}
    assert {"checkpoint", "spill"} <= ops
    summary = S.serving.serving_summary()["telemetry"]
    assert summary["store"] == "DiskStore" and summary["store_persistent"]
    assert summary["checkpoints"] >= 2 and summary["journal_appends"] >= 4
    stats = S.serving.durability_stats()
    assert stats["spill_writes"] > 0 and stats["journal_bytes"] > 0
    text = S.obs.prometheus_text()
    families = sorted({line.split(" ")[0] for line in text.splitlines() if line.startswith("metrics_tpu_durable_")})
    assert "metrics_tpu_durable_spill_writes" in families
    journal = [(e.kind, e.data) for e in events if e.kind in ("journal", "spill_write")]
    return {"journal": journal, "families": families, "stats": dict(bank.stats)}


def sc_default_bank_local(S, tmp):
    bank = S.bank(acc(S), capacity=2)
    assert isinstance(bank.store, S.serving.MemoryStore) and not bank.store.persistent
    bank.update("a", *req(S, 0))
    bank.evict("a")
    assert "a" in bank.spilled_tenants and bank.store.exists(bank._spilled["a"])
    return dict(bank.stats)


DURABLE_CASES = {
    "store_blob_round_trip[memory]": (sc_blob_round_trip, "memory"),
    "store_blob_round_trip[disk]": (sc_blob_round_trip, "disk"),
    "store_journal_round_trip[memory]": (sc_journal_round_trip, "memory"),
    "store_journal_round_trip[disk]": (sc_journal_round_trip, "disk"),
    "disk_journal_torn_tail_is_dropped": (sc_torn_tail_dropped,),
    "read_journal_stops_at_crc_corrupted_record[memory]": (sc_crc_corrupted, "memory"),
    "read_journal_stops_at_crc_corrupted_record[disk]": (sc_crc_corrupted, "disk"),
    "durable_token_round_trip_and_rejection": (sc_tokens,),
    "bank_rejects_unjournalable_tenant_id": (sc_unjournalable_tenant,),
    "recover_restores_every_acked_tenant_bit_identically": (sc_recover_every_tenant,),
    "double_recovery_is_idempotent": (sc_double_recovery,),
    "recover_ignores_torn_journal_tail": (sc_recover_torn_tail,),
    "framing_torn_tail_is_counted_and_truncated_before_append": (sc_framing_torn_counted,),
    "journal_drop_on_dead_namespace_survives_torn_tail": (sc_drop_dead_namespace,),
    "async_checkpoint_correct_across_fluctuating_dirty_counts": (sc_async_fluctuating,),
    "recover_rewrites_torn_journal_so_later_records_replay": (sc_recover_rewrites_torn,),
    "checkpoint_cadence_bounds_the_durability_window": (sc_cadence_window,),
    "never_checkpointed_admission_recovers_at_defaults": (sc_never_checkpointed,),
    "dropped_tenants_stay_dropped_after_recovery": (sc_dropped_stay_dropped,),
    "async_checkpoint_watermark_trails_one_boundary": (sc_async_trails,),
    "async_checkpoint_forced_seal_with_empty_call": (sc_async_forced_seal,),
    "async_stale_seal_never_rolls_durable_state_back": (sc_async_no_rollback,),
    "async_stale_seal_skipped_for_dropped_then_readmitted_tenant": (sc_async_regen,),
    "journal_bounded_without_checkpoint_cadence": (sc_journal_bounded_no_cadence,),
    "int8_tagged_state_spills_and_restores_bit_identically": (sc_int8_tagged_exact,),
    "journal_compaction_bounds_admission_churn": (sc_compaction_bounds_churn,),
    "durability_events_and_summary": (sc_events_and_summary,),
    "default_bank_stays_process_local": (sc_default_bank_local,),
}


@pytest.mark.parametrize("case", list(DURABLE_CASES))
def test_durable_bank_matches_jax(case, tmp_path):
    fn, *args = DURABLE_CASES[case]
    run_both(lambda S, *a: fn(S, tmp_path, *a), *args)


def test_sharded_annotation_rides_recovery_without_a_mesh(tmp_path):
    """The single-device half of ``test_sharded_states_recover_and_replace_on_mesh``:
    a template whose state registered ``sharding=`` recovers bit for bit from
    a bank without a mesh, and the annotation survives on the materialized
    metric in both packages (placing it on a mesh is item 8b's)."""

    def scenario(S, tmp):
        store = disk(S, tmp)
        template = S.m("StatScores", reduce="macro", num_classes=32, class_sharding="mp")
        solo = template.clone()
        bank = S.bank(template, capacity=1, name="sharded", spill_store=store, checkpoint_every_n_flushes=1)
        rng = np.random.RandomState(0)
        for _ in range(3):
            r = (S.arr(rng.randint(0, 32, size=8).astype(np.int32)), S.arr(rng.randint(0, 32, size=8).astype(np.int32)))
            solo.update(*r)
            bank.update("T", *r)
        del bank
        recovered = S.serving.MetricBank.recover(template.clone(), 1, store, name="sharded")
        equals_solo(recovered, "T", solo)
        spec = recovered.materialize("T")._state_shardings["tp"]
        assert "mp" in str(spec)
        return {**recovered_obs(recovered), "written": store_bytes(store, ["sharded"])}

    run_both(lambda S: scenario(S, tmp_path))


# ---------------------------------------------------------------------------
# cross-package recovery through one DiskStore
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("writer", SIDES)
def test_disk_store_recovers_in_the_other_package(writer, tmp_path):
    """A ``DiskStore`` written by one package (spills, checkpoints, a drop,
    a never-checkpointed admission) recovers in the other, bit for bit, and
    the other serves on from it."""
    reader = "torch" if writer == "jax" else "jax"
    W, R = Side(writer), Side(reader)
    root = str(tmp_path / "shared")
    tenants = [f"t{i}" for i in range(4)]
    solos = {t: acc(R) for t in tenants}
    bank = W.bank(acc(W), capacity=2, name="shared", spill_store=W.serving.DiskStore(root), checkpoint_every_n_flushes=1)
    for step in range(3):
        for i, t in enumerate(tenants):
            bank.update(t, *req(W, 1000 * step + i))
            solos[t].update(*req(R, 1000 * step + i))
    bank.update("gone", *req(W, 5))
    bank.evict("gone", spill=False)
    bank.admit("fresh")
    bank.checkpoint()
    del bank
    recovered = R.serving.MetricBank.recover(
        acc(R), 2, R.serving.DiskStore(root), name="shared", checkpoint_every_n_flushes=1
    )
    assert sorted(recovered.spilled_tenants, key=str) == sorted(tenants + ["fresh"])
    for t in tenants:
        equals_solo(recovered, t, solos[t])
    assert recovered.update_count("fresh") == 0
    r = req(R, 77)
    recovered.update("t1", *r)
    solos["t1"].update(*r)
    equals_solo(recovered, "t1", solos["t1"])
    # and the reader's writes decode in the writer's package
    del recovered
    back = W.serving.MetricBank.recover(acc(W), 2, W.serving.DiskStore(root), name="shared")
    same(host(back.tenant_state("t1")), host(solos["t1"]._snapshot_state()))
    assert back.update_count("t1") == 4


# ---------------------------------------------------------------------------
# the golden compat corpus
# ---------------------------------------------------------------------------
def _golden():
    with open(os.path.join(GOLDEN, "index.json")) as fh:
        index = json.load(fh)["artifacts"]
    return [e for e in index if e["family"] in ("journal", "payload")]


@pytest.mark.parametrize("entry", _golden(), ids=lambda e: e["file"])
def test_golden_journal_and_payload_artifacts(entry):
    from metrics_tpu.resilience import schema as jschema
    from metrics_tpu_torch.resilience import schema
    from metrics_tpu_torch.utils.exceptions import SchemaVersionError

    import metrics_tpu_torch.serving  # noqa: F401  (registers the families)

    with open(os.path.join(GOLDEN, entry["file"]), "rb") as fh:
        raw = fh.read()
    if entry["expect"] == "reject":
        with pytest.raises(SchemaVersionError, match="NEWER build") as err:
            schema.decode_any(entry["family"], raw, context=" (golden)")
        assert (err.value.family, err.value.version) == (entry["family"], entry["version"])
        assert err.value.current == schema.current_version(entry["family"]) == 2
        return
    got = schema.decode_any(entry["family"], raw, context=" (golden)")
    want = jschema.decode_any(entry["family"], raw, context=" (golden)")
    if entry["family"] == "journal":
        assert got == want and got["v"] == 2
        if entry["version"] == 1:
            assert got["digest"] is None and got["op"] == "admit" and got["count"] == 3
        return
    assert sorted(got) == sorted(want) == ["count", "total"]
    for key in got:
        a, b = np.asarray(want[key]), got[key].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(got["total"].numpy(), np.arange(6, dtype=np.float32) * 0.5)


# ---------------------------------------------------------------------------
# kill -9 a serving process that imports only torch and the port
# ---------------------------------------------------------------------------
_CHILD = r"""
import os, signal, sys
import numpy as np
import torch
sys.path.insert(0, os.environ["REPO"])
from metrics_tpu_torch import Accuracy
from metrics_tpu_torch.serving import DiskStore, MetricBank

bank = MetricBank(
    Accuracy(num_classes=5, device="cpu"), capacity=2, name="victim",
    spill_store=DiskStore(os.environ["DURABLE_ROOT"]), checkpoint_every_n_flushes=1,
)
for step in range(100):
    for i, t in enumerate(["t0", "t1", "t2", "t3"]):
        rng = np.random.RandomState(1000 * step + i)
        preds = torch.as_tensor(rng.rand(8, 5).astype(np.float32))
        target = torch.as_tensor(rng.randint(0, 5, size=8).astype(np.int32))
        bank.update(t, preds, target)
    if step == 3:
        assert "jax" not in sys.modules and "metrics_tpu" not in sys.modules
        print("ACKED", flush=True)
        os.kill(os.getpid(), signal.SIGKILL)
"""


def test_kill_minus_nine_child_recovers_in_this_process(tmp_path):
    from metrics_tpu_torch import Accuracy
    from metrics_tpu_torch.serving import DiskStore, MetricBank

    root = str(tmp_path / "store")
    env = dict(os.environ, DURABLE_ROOT=root, REPO=REPO)
    proc = subprocess.run([sys.executable, "-c", _CHILD], env=env, capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    assert "ACKED" in proc.stdout
    tenants = ["t0", "t1", "t2", "t3"]
    solos = {t: Accuracy(num_classes=NUM_CLASSES, device="cpu") for t in tenants}
    for step in range(4):
        for i, t in enumerate(tenants):
            rng = np.random.RandomState(1000 * step + i)
            solos[t].update(
                torch.as_tensor(rng.rand(8, NUM_CLASSES).astype(np.float32)),
                torch.as_tensor(rng.randint(0, NUM_CLASSES, size=8).astype(np.int32)),
            )
    recovered = MetricBank.recover(Accuracy(num_classes=NUM_CLASSES, device="cpu"), 2, DiskStore(root), name="victim")
    assert sorted(recovered.spilled_tenants) == tenants
    for t in tenants:
        equals_solo(recovered, t, solos[t])

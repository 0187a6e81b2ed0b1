"""The port's bank-bound integrity plane (``metrics_tpu_torch.resilience.integrity``
with ``MetricBank(audit_rate=)``) and the tenant-payload codec under
corruption, against ``metrics_tpu`` on the same numpy inputs.

Each case of ``tests/serving/test_bank_integrity.py`` and
``tests/serving/test_payload_fuzz.py`` runs as a scenario on both packages
(the harness of ``tests/test_torch_serving.py``); the observations must
agree: the digests recorded and verified, the audit verdicts, the site
``inject_bitflip`` flips (a pure function of ``seq``, the same bit in both
packages), the repaired states, and the payload bytes and the exception
each corrupted payload raises. Besides: a fault plan's ``'bitflip'`` spec
drives ``bitflip_injector``, and each package decodes and verifies the
other's payloads.
"""
import importlib

import numpy as np
import pytest

from tests.test_torch_serving import NUM_CLASSES, SIDES, Side, host, req, run_both, same, states_equal_solo


def acc(S):
    return S.m("Accuracy", num_classes=NUM_CLASSES)


def bank(S, store=None, **kwargs):
    return S.bank(acc(S), capacity=kwargs.pop("capacity", 4), spill_store=store, **kwargs)


def solo_of(S, seeds):
    solo = acc(S)
    for seed in seeds:
        solo.update(*req(S, seed))
    return solo


def istats(S):
    return S.integrity.integrity_stats()


def run(scenario):
    def wrapped(S):
        S.integrity.reset_integrity_stats()
        out = scenario(S)
        return {"out": out, "integrity": istats(S)}

    return run_both(wrapped)


# ---------------------------------------------------------------------------
# tests/serving/test_bank_integrity.py
# ---------------------------------------------------------------------------
def sc_spill_readmit_verifies(S):
    store = S.serving.MemoryStore()
    b = bank(S, store, name="att0")
    b.apply_batch([("t0", req(S, 0)), ("t1", req(S, 1))])
    b.evict("t0")
    assert istats(S)["attests_recorded"] >= 1
    b.admit("t0")
    assert istats(S)["attests_verified"] >= 1 and istats(S)["attest_failures"] == 0
    return store.get(b._blob_key("t0"))


def sc_corrupted_blob(S):
    store = S.serving.MemoryStore()
    b = bank(S, store, name="att1")
    b.apply_batch([("t0", req(S, 0))])
    b.evict("t0")
    key = b._blob_key("t0")
    forged = S.integrity.forge_payload_corruption(store.get(key))
    store.put(key, forged)
    with pytest.raises(S.exc.StateIntegrityError) as err:
        b.admit("t0")
    assert err.value.tenant is not None or err.value.leaf is not None
    return {"forged": forged, "leaf": err.value.leaf}


def sc_swapped_blob(S):
    store = S.serving.MemoryStore()
    b = bank(S, store, name="att2")
    target = np.arange(8, dtype=np.int32) % NUM_CLASSES
    right = np.eye(NUM_CLASSES, dtype=np.float32)[target]
    wrong = np.eye(NUM_CLASSES, dtype=np.float32)[(target + 1) % NUM_CLASSES]
    b.apply_batch([("t0", (S.arr(right), S.arr(target))), ("t1", (S.arr(wrong), S.arr(target)))])
    b.evict("t0")
    b.evict("t1")
    store.put(b._blob_key("t0"), store.get(b._blob_key("t1")))
    with pytest.raises(S.exc.StateIntegrityError, match="journal attestation") as err:
        b.admit("t0")
    return {"leaf": err.value.leaf, "tenant": str(err.value.tenant)}


def sc_recover_carries_attestations(S):
    store = S.serving.MemoryStore()
    b = bank(S, store, name="att3", checkpoint_every_n_flushes=1)
    for step in range(3):
        b.apply_batch([("t0", req(S, step)), ("t1", req(S, 100 + step))])
    recovered = S.serving.MetricBank.recover(acc(S), 4, store, name="att3")
    before = istats(S)["attests_verified"]
    recovered.admit("t0")
    assert istats(S)["attests_verified"] > before
    key = recovered._blob_key("t1")
    store.put(key, S.integrity.forge_payload_corruption(store.get(key)))
    with pytest.raises(S.exc.StateIntegrityError):
        recovered.admit("t1")
    return host(recovered.tenant_state("t0"))


def sc_import_rejects_forged(S):
    store = S.serving.MemoryStore()
    src = bank(S, store, name="att4")
    src.apply_batch([("t0", req(S, 0))])
    payload = src.export_payload("t0")
    dest = bank(S, name="att5")
    forged = S.integrity.forge_payload_corruption(payload)
    with pytest.raises(S.exc.StateIntegrityError):
        if S.name == "jax":
            from metrics_tpu.fleet import admit_payload

            admit_payload(dest, "t0", forged)
        else:
            dest.import_tenant("t0", S.store.decode_tenant_payload(forged))
    assert "t0" not in dest.tenants and "t0" not in dest.spilled_tenants
    # the clean payload imports
    dest.import_tenant("t0", S.store.decode_tenant_payload(payload))
    return {"payload": payload, "state": host(dest.tenant_state("t0")), "count": dest.update_count("t0")}


def sc_audit_rate_validation(S):
    messages = []
    for i, rate in enumerate((0.0, 1.5)):
        with pytest.raises(ValueError) as err:
            bank(S, name=f"bad{i}", audit_rate=rate)
        messages.append(str(err.value))
    return messages


def sc_audit_period(S):
    b = bank(S, name="aud0", audit_rate=1.0 / 4.0)
    for step in range(8):
        b.apply_batch([("t0", req(S, step))])
    assert b.stats["audits_sampled"] == 2
    audits = b.take_audits()
    assert len(audits) == 2 and b.take_audits() == []
    return [(a.tenant, a.count_before, a.flush_index, len(a.args_list), host(a.capture.result())) for a in audits]


def sc_auditor_clean(S):
    b = bank(S, name="aud1", audit_rate=1.0)
    auditor = S.integrity.IntegrityAuditor(b)
    verdicts = []
    for step in range(4):
        b.apply_batch([("t0", req(S, step)), ("t1", req(S, 50 + step))])
        verdicts.append(auditor.poll())
    stats = istats(S)
    assert stats["audits_checked"] == 4 and stats["audits_passed"] == 4 and stats["audit_failures"] == 0
    assert auditor.last_failure is None
    return verdicts


def sc_auditor_repairs(S):
    store = S.serving.MemoryStore()
    b = bank(S, store, name="aud2", checkpoint_every_n_flushes=1, audit_rate=1.0)
    b.apply_batch([("t0", req(S, 0))])
    sites = []
    b.state_fault_injector = lambda tenants: sites.append(S.integrity.inject_bitflip(b, tenants[0], seq=0))
    b.apply_batch([("t0", req(S, 1))])
    b.state_fault_injector = None
    auditor = S.integrity.IntegrityAuditor(b)
    verdict = auditor.poll()
    assert auditor.last_failure is not None and auditor.last_failure["tenant"] == "t0"
    assert b.stats["repairs"] == 1
    states_equal_solo(b, "t0", solo_of(S, [0, 1]))
    return {"sites": sites, "verdict": verdict, "failure": auditor.last_failure, "stats": dict(b.stats)}


def sc_auditor_reports_only(S):
    store = S.serving.MemoryStore()
    b = bank(S, store, name="aud3", checkpoint_every_n_flushes=1, audit_rate=1.0)
    b.state_fault_injector = lambda tenants: S.integrity.inject_bitflip(b, tenants[0], seq=0)
    b.apply_batch([("t0", req(S, 0))])
    b.state_fault_injector = None
    auditor = S.integrity.IntegrityAuditor(b, repair=False)
    verdict = auditor.poll()
    assert auditor.last_failure is not None and b.stats["repairs"] == 0
    return {"verdict": verdict, "failure": auditor.last_failure, "state": host(b.tenant_state("t0"))}


def sc_pending_bounded(S):
    b = bank(S, name="aud4", audit_rate=1.0)
    for step in range(70):
        b.apply_batch([("t0", req(S, step % 4))])
    assert len(b._pending_audits) <= 64 and istats(S)["audits_dropped"] >= 6
    return len(b._pending_audits)


def sc_audit_records_neutral(S):
    store = S.serving.MemoryStore()
    b = bank(S, store, name="aud5", audit_rate=1.0)
    for step in range(3):
        b.apply_batch([("t0", req(S, step))])
    live, torn = S.store.replay_journal(store, "aud5")
    assert torn == 0 and set(live) == {"t0"}
    return store.journal_frames("aud5")


def sc_repair_last_checkpoint(S):
    store = S.serving.MemoryStore()
    b = bank(S, store, name="rep0", checkpoint_every_n_flushes=None)
    b.apply_batch([("t0", req(S, 0))])
    b.checkpoint(["t0"])
    b.apply_batch([("t0", req(S, 1))])
    site = S.integrity.inject_bitflip(b, "t0", seq=0)
    restored = b.repair_tenant("t0")
    assert restored == 1 and b.stats["repairs"] == 1
    states_equal_solo(b, "t0", solo_of(S, [0]))
    return {"site": site, "restored": restored}


def sc_repair_unknown(S):
    b = bank(S, S.serving.MemoryStore(), name="rep1")
    with pytest.raises(KeyError) as err:
        b.repair_tenant("ghost")
    return str(err.value)


def sc_repair_never_seals(S):
    store = S.serving.MemoryStore()
    b = bank(S, store, name="rep2", checkpoint_every_n_flushes=1)
    b.apply_batch([("t0", req(S, 0))])
    clean = store.get(b._blob_key("t0"))
    S.integrity.inject_bitflip(b, "t0", seq=0)
    b.repair_tenant("t0")
    assert store.get(b._blob_key("t0")) == clean
    return clean


def sc_events(S):
    store = S.serving.MemoryStore()
    b = bank(S, store, name="obs0", checkpoint_every_n_flushes=1, audit_rate=1.0)
    with S.obs.capture(kinds=("attest", "audit", "repair")) as events:
        b.apply_batch([("t0", req(S, 0))])
        b.state_fault_injector = lambda tenants: S.integrity.inject_bitflip(b, tenants[0], seq=0)
        b.apply_batch([("t0", req(S, 1))])
        b.state_fault_injector = None
        S.integrity.IntegrityAuditor(b).poll()
    kinds = {e.kind for e in events}
    assert "audit" in kinds and "repair" in kinds
    bad = [e for e in events if e.kind == "audit" and not e.data.get("ok")]
    assert bad and bad[0].data.get("tenant")
    return [(e.kind, e.data) for e in events]


def sc_snapshot_section(S):
    snap = S.obs.snapshot()
    for key in ("attests_verified", "audit_failures", "repairs"):
        assert key in snap["integrity"]
    return sorted(snap["integrity"])


INTEGRITY_CASES = {
    "spill_readmit_verifies_digests": sc_spill_readmit_verifies,
    "corrupted_blob_detected_at_readmit": sc_corrupted_blob,
    "swapped_blob_caught_by_journal_digest": sc_swapped_blob,
    "recover_carries_attestations": sc_recover_carries_attestations,
    "import_rejects_forged_migration_payload": sc_import_rejects_forged,
    "audit_rate_validation": sc_audit_rate_validation,
    "audit_sampling_period": sc_audit_period,
    "auditor_passes_clean_traffic": sc_auditor_clean,
    "auditor_detects_and_repairs_corruption": sc_auditor_repairs,
    "auditor_without_repair_only_reports": sc_auditor_reports_only,
    "pending_audits_bounded": sc_pending_bounded,
    "audit_journal_records_are_replay_neutral": sc_audit_records_neutral,
    "repair_tenant_restores_last_checkpoint": sc_repair_last_checkpoint,
    "repair_unknown_tenant_raises": sc_repair_unknown,
    "repair_never_seals_corruption": sc_repair_never_seals,
    "integrity_events_on_bus": sc_events,
    "snapshot_has_integrity_section": sc_snapshot_section,
}


@pytest.mark.parametrize("case", list(INTEGRITY_CASES))
def test_bank_integrity_matches_jax(case):
    run(INTEGRITY_CASES[case])


# ---------------------------------------------------------------------------
# tests/serving/test_payload_fuzz.py
# ---------------------------------------------------------------------------
_ENVELOPE_BITS = 7 * 8
_BODY_SAMPLES = 128


def _tree():
    rng = np.random.RandomState(0)
    return {
        "tp": rng.randint(0, 100, size=5).astype(np.int64),
        "fp": rng.randint(0, 100, size=5).astype(np.int64),
        "total": np.asarray(40, np.int64),
        "weights": rng.rand(3, 4).astype(np.float32),
        "_update_count": np.asarray(7, np.int64),
    }


def _fuzz_bits(payload: bytes, seed: int):
    nbits = len(payload) * 8
    bits = set(range(min(_ENVELOPE_BITS, nbits)))
    rng = np.random.RandomState(seed)
    span = nbits - _ENVELOPE_BITS
    if span > 0:
        bits.update(int(p) + _ENVELOPE_BITS for p in rng.choice(span, size=min(_BODY_SAMPLES, span), replace=False))
        bits.update((_ENVELOPE_BITS, nbits - 1))
    return sorted(bits)


def _flip_verdicts(S, payload: bytes, seed: int):
    """The exception each single-bit flip raises; a silent decode fails."""
    out = []
    for bit in _fuzz_bits(payload, seed):
        raw = bytearray(payload)
        raw[bit // 8] ^= 1 << (bit % 8)
        try:
            S.store.decode_tenant_payload(bytes(raw), context=" (fuzz)")
        except (S.exc.SyncIntegrityError, S.exc.StateIntegrityError) as err:
            out.append((bit, type(err).__name__))
            continue
        pytest.fail(f"bit {bit} of {len(payload) * 8} decoded silently")
    return out


def sc_clean_round_trip(S):
    tree = _tree()
    payload = S.store.encode_tenant_payload(tree)
    decoded = S.store.decode_tenant_payload(payload)
    assert sorted(decoded) == sorted(tree)
    for key, value in tree.items():
        np.testing.assert_array_equal(host(decoded[key]), value, err_msg=key)
    return {"payload": payload, "decoded": host(decoded)}


def sc_exact_flips(S):
    payload = S.store.encode_tenant_payload(_tree())
    return {"payload": payload, "verdicts": _flip_verdicts(S, payload, 1)}


def sc_quantized_flips(S):
    payload = S.store.encode_tenant_payload(_tree(), precisions={"weights": "int8"})
    return {"payload": payload, "verdicts": _flip_verdicts(S, payload, 2)}


def sc_large_flips(S):
    payload = S.store.encode_tenant_payload({"big": np.random.RandomState(3).rand(64, 64).astype(np.float32)})
    return {"payload": payload, "verdicts": _flip_verdicts(S, payload, 4)}


def sc_forge_needs_digests(S):
    forged = S.integrity.forge_payload_corruption(S.store.encode_tenant_payload(_tree()))
    with pytest.raises(S.exc.StateIntegrityError) as err:
        S.store.decode_tenant_payload(forged)
    return {"forged": forged, "leaf": err.value.leaf}


FUZZ_CASES = {
    "clean_payload_round_trips": sc_clean_round_trip,
    "every_flip_over_exact_payload_detected": sc_exact_flips,
    "every_flip_over_quantized_payload_detected": sc_quantized_flips,
    "every_flip_over_large_payload_detected": sc_large_flips,
    "crc_consistent_forge_needs_digests": sc_forge_needs_digests,
}


@pytest.mark.parametrize("case", list(FUZZ_CASES))
def test_payload_fuzz_matches_jax(case):
    run(FUZZ_CASES[case])


# ---------------------------------------------------------------------------
# the port's own wiring
# ---------------------------------------------------------------------------
def test_fault_plan_bitflip_drives_the_injector():
    """A ``'bitflip'`` spec owes ``times`` flips: the injector flips on the
    first two flushes (sequence 0 and 1, the JAX sites), then the fault heals."""
    import metrics_tpu_torch as mt
    from metrics_tpu.resilience import integrity as jintegrity

    S = Side("torch")
    plan = mt.resilience.parse_plan('[{"kind": "bitflip", "rank": 3, "times": 2}]')
    b = bank(S, S.serving.MemoryStore(), name="planned")
    b.state_fault_injector = mt.resilience.integrity.bitflip_injector(b, plan, rank=3)
    before = mt.resilience.integrity_stats()["bitflips_injected"]
    for step in range(4):
        b.apply_batch([("t0", req(S, step)), ("t1", req(S, 10 + step))])
    assert mt.resilience.integrity_stats()["bitflips_injected"] == before + 2
    # the flushes' rows differ from a clean bank's exactly at the JAX sites
    clean = bank(S, S.serving.MemoryStore(), name="clean")
    for step in range(4):
        clean.apply_batch([("t0", req(S, step)), ("t1", req(S, 10 + step))])
    diffs = {}
    for t in ("t0", "t1"):
        got, want = b.tenant_state(t), clean.tenant_state(t)
        diffs[t] = sorted(n for n in got if not np.array_equal(host(got[n]), host(want[n])))
    assert diffs == {"t0": [sorted(clean._bank)[0]], "t1": [sorted(clean._bank)[1]]}
    assert jintegrity.inject_bitflip.__name__ == "inject_bitflip"


@pytest.mark.parametrize("writer", SIDES)
def test_each_package_verifies_the_others_payloads(writer):
    """Float states: the digests follow the bytes, so each package decodes
    and verifies the payload the other sealed, leaf for leaf."""
    reader = "torch" if writer == "jax" else "jax"
    W, R = Side(writer), Side(reader)
    m = W.m("MeanSquaredError")
    rng = np.random.RandomState(4)
    m.update(W.arr(rng.rand(32).astype(np.float32)), W.arr(rng.rand(32).astype(np.float32)))
    b = W.bank(m, capacity=1, name="floats")
    b.import_tenant("f", importlib.import_module(f"{W.pkg.__name__}.utils.checkpoint").metric_state_pytree(m))
    payload = b.export_payload("f")
    tree = R.store.decode_tenant_payload(payload)
    want = W.store.decode_tenant_payload(payload)
    same(host(want), host(tree))
    R.integrity.verify_tree(tree, R.integrity.state_digest(want))


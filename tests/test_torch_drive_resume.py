"""Drive snapshots of the port (``metrics_tpu_torch.engine.drive(snapshot_store=,
snapshot_every=, resume_from=)``) against uninterrupted drives and the JAX
package's, on the CPU. It mirrors ``tests/engine/test_drive_resume.py``, and
adds the cross-package resume in both directions (a snapshot sealed by one
package resumes the other's drive: the bytes are the same) and the golden
snapshot artifacts through the port's schema registry.

Tolerances: states, counts and values bit for bit against the port's own
uninterrupted drive; against the JAX package, integer states bit for bit and
float values within 1e-6 relative (the tests' x64 lane: both count in int64).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mj
import metrics_tpu_torch as mt
from metrics_tpu import engine as ej
from metrics_tpu.engine import driver as jdriver
from metrics_tpu.serving import MemoryStore as JMemoryStore
from metrics_tpu_torch import engine as et
from metrics_tpu_torch import obs
from metrics_tpu_torch.engine import driver
from metrics_tpu_torch.serving import DiskStore, MemoryStore
from metrics_tpu_torch.utils.exceptions import MetricsUserError, StateIntegrityError

NUM_CLASSES = 5
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "compat", "golden")


@pytest.fixture(autouse=True)
def _fresh_cache():
    et.clear_cache()
    ej.clear_cache()
    yield
    et.clear_cache()
    ej.clear_cache()


def _epoch(rng, n_steps=8, batch=16, c=NUM_CLASSES, nan_every=None):
    preds = rng.rand(n_steps, batch, c).astype(np.float32)
    target = rng.randint(0, c, size=(n_steps, batch)).astype(np.int64)
    if nan_every:
        for i in range(0, n_steps, nan_every):
            preds[i, :3, 0] = np.nan
    return torch.from_numpy(preds), torch.from_numpy(target)


def _assert_state_equal(m_a, m_b):
    sa, sb = m_a._snapshot_state(), m_b._snapshot_state()
    assert set(sa) == set(sb)
    for name in sa:
        assert sa[name].dtype == sb[name].dtype, name
        assert torch.equal(sa[name], sb[name]), name


def _assert_like_jax(port_metric, jax_metric, rtol=1e-6):
    for name, value in port_metric._snapshot_state().items():
        j = np.asarray(getattr(jax_metric, name))
        assert value.numpy().dtype.kind == j.dtype.kind, name
        if j.dtype.kind in "iub":
            np.testing.assert_array_equal(value.numpy(), j, err_msg=name)
        else:
            np.testing.assert_allclose(value.numpy(), j, rtol=rtol, err_msg=name)
    got, want = port_metric.compute().numpy(), np.asarray(jax_metric.compute())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


def _interrupted(stream, die_after):
    """A host iterator that dies after ``die_after`` steps: a preemption."""

    class _Preempted(RuntimeError):
        pass

    def _gen():
        for i, step in enumerate(stream):
            if i == die_after:
                raise _Preempted(f"preempted at step {i}")
            yield step

    return _gen(), _Preempted


FACTORIES = [
    pytest.param(lambda: mt.SumMetric(nan_strategy="disable", device="cpu"), True, id="sum"),
    pytest.param(lambda: mt.MeanMetric(nan_strategy="disable", device="cpu"), True, id="mean"),
    pytest.param(lambda: mt.Accuracy(num_classes=NUM_CLASSES, device="cpu"), False, id="accuracy"),
    pytest.param(lambda: mt.StatScores(reduce="macro", num_classes=NUM_CLASSES, device="cpu"), False, id="stat_scores"),
    pytest.param(lambda: mt.ConfusionMatrix(num_classes=NUM_CLASSES, device="cpu"), False, id="confmat"),
]


@pytest.mark.parametrize("factory, agg", FACTORIES)
def test_resume_bit_identity_vs_uninterrupted(factory, agg):
    """A stacked epoch interrupted at step 6; a FRESH metric resumed from
    the store ends bit for bit where the uninterrupted drive ends."""
    rng = np.random.RandomState(0)
    preds, target = _epoch(rng, n_steps=9)
    epoch = (preds.sum(-1),) if agg else (preds, target)

    m_plain = factory()
    et.drive(m_plain, epoch)

    store = MemoryStore()
    m_dead = factory()
    res = et.drive(m_dead, tuple(x[:6] for x in epoch), snapshot_store=store)
    assert res.snapshots >= 1
    snap = driver.load_drive_snapshot(store)
    assert snap.step == 6 and snap.final

    m_resume = factory()
    res2 = et.drive(m_resume, epoch, resume_from=store)
    assert res2.steps == 3
    _assert_state_equal(m_resume, m_plain)
    assert torch.equal(m_resume.compute(), m_plain.compute())
    assert m_resume._update_count == m_plain._update_count


@pytest.mark.parametrize("policy", ["skip", "mask"])
def test_resume_health_counter_parity(policy):
    """The health counters (states) and the host screening counter resume
    with the states."""
    rng = np.random.RandomState(1)
    preds, target = _epoch(rng, n_steps=8, nan_every=3)
    make = lambda: mt.Accuracy(num_classes=NUM_CLASSES, on_bad_input=policy, device="cpu")  # noqa: E731

    m_plain = make()
    et.drive(m_plain, (preds, target))
    store = MemoryStore()
    et.drive(make(), (preds[:5], target[:5]), snapshot_store=store)
    m_resume = make()
    et.drive(m_resume, (preds, target), resume_from=store)

    _assert_state_equal(m_resume, m_plain)
    assert torch.equal(m_resume.compute(), m_plain.compute())
    plain_rep, resume_rep = m_plain.health_report(), m_resume.health_report()
    for key in ("batches_screened", "updates_quarantined", "rows_masked", "nan_count"):
        assert resume_rep[key] == plain_rep[key], key


def test_streaming_interrupt_then_resume_ragged_tail():
    """A streamed epoch dies mid-way after sealing a mid-epoch snapshot; the
    same stream, a ragged last batch included, resumes bit for bit."""
    rng = np.random.RandomState(2)
    preds, target = _epoch(rng, n_steps=10)
    stream = [(preds[i], target[i]) for i in range(10)]
    stream[-1] = (preds[9][:7], target[9][:7])

    m_plain = mt.Accuracy(num_classes=NUM_CLASSES, device="cpu")
    et.drive(m_plain, iter(stream), steps_per_chunk=2)

    store = MemoryStore()
    dead_iter, preempted = _interrupted(stream, die_after=7)
    with pytest.raises(preempted):
        et.drive(
            mt.Accuracy(num_classes=NUM_CLASSES, device="cpu"), dead_iter, steps_per_chunk=2,
            snapshot_store=store, snapshot_every=2,
        )
    snap = driver.load_drive_snapshot(store)
    assert 0 < snap.step < 10 and not snap.final

    m_resume = mt.Accuracy(num_classes=NUM_CLASSES, device="cpu")
    res = et.drive(m_resume, iter(stream), steps_per_chunk=2, resume_from=store)
    assert res.steps == 10 - snap.step
    _assert_state_equal(m_resume, m_plain)
    assert torch.equal(m_resume.compute(), m_plain.compute())


def test_resume_zero_extra_compiles():
    """With the interrupted run's chunk geometry cached, the resumed drive
    makes no new program."""
    rng = np.random.RandomState(3)
    preds, target = _epoch(rng, n_steps=8)
    store = MemoryStore()
    et.drive(mt.Accuracy(num_classes=NUM_CLASSES, device="cpu"), (preds[:4], target[:4]), snapshot_store=store, snapshot_every=2)
    before = et.cache_summary()["compiles"]

    m_resume = mt.Accuracy(num_classes=NUM_CLASSES, device="cpu")
    res = et.drive(m_resume, (preds, target), resume_from=store, snapshot_store=store, snapshot_every=2)
    assert res.steps == 4 and res.snapshots >= 1
    assert et.cache_summary()["compiles"] == before

    m_plain = mt.Accuracy(num_classes=NUM_CLASSES, device="cpu")
    et.drive(m_plain, (preds, target))
    _assert_state_equal(m_resume, m_plain)


def test_sliced_snapshot_epoch_matches_single_launch():
    """``snapshot_every`` below the epoch runs a stacked epoch in chunks of
    that many steps, bit for bit equal to one chunk."""
    rng = np.random.RandomState(4)
    preds, target = _epoch(rng, n_steps=7)
    m_one = mt.ConfusionMatrix(num_classes=NUM_CLASSES, device="cpu")
    et.drive(m_one, (preds, target))
    store = MemoryStore()
    m_sliced = mt.ConfusionMatrix(num_classes=NUM_CLASSES, device="cpu")
    res = et.drive(m_sliced, (preds, target), snapshot_store=store, snapshot_every=3)
    assert res.chunks == 3  # 3 + 3 + 1
    assert res.snapshots == 3  # boundaries at 3 and 6, the final at 7
    _assert_state_equal(m_sliced, m_one)
    assert driver.load_drive_snapshot(store).step == 7


def test_resume_of_completed_epoch_is_idempotent_noop():
    """A final snapshot covering the whole epoch binds and runs nothing; a
    never-updated instance computes through the snapshot's learned
    attributes (``Accuracy.mode``)."""
    rng = np.random.RandomState(5)
    preds, target = _epoch(rng, n_steps=6)
    store = MemoryStore()
    m_full = mt.Accuracy(num_classes=NUM_CLASSES, device="cpu")
    et.drive(m_full, (preds, target), snapshot_store=store)

    m_again = mt.Accuracy(num_classes=NUM_CLASSES, device="cpu")
    res = et.drive(m_again, (preds, target), resume_from=store)
    assert res.steps == 0 and res.chunks == 0
    _assert_state_equal(m_again, m_full)
    assert torch.equal(m_again.compute(), m_full.compute())
    assert m_again._update_count == m_full._update_count


def test_empty_epoch_with_snapshot_store_still_seals_a_final_snapshot():
    store = MemoryStore()
    res = et.drive(mt.SumMetric(nan_strategy="disable", device="cpu"), (torch.zeros((0, 4)),), snapshot_store=store)
    assert res.steps == 0 and res.snapshots == 1
    res2 = et.drive(mt.SumMetric(nan_strategy="disable", device="cpu"), (torch.zeros((0, 4)),), resume_from=store)
    assert res2.steps == 0
    store2 = MemoryStore()
    res3 = et.drive(mt.SumMetric(nan_strategy="disable", device="cpu"), iter([]), snapshot_store=store2)
    assert res3.snapshots == 1
    et.drive(mt.SumMetric(nan_strategy="disable", device="cpu"), iter([]), resume_from=store2)


def _collection(pkg, **kw):
    return pkg.MetricCollection(
        {
            "acc": pkg.Accuracy(num_classes=NUM_CLASSES, **kw),
            "confmat": pkg.ConfusionMatrix(num_classes=NUM_CLASSES, **kw),
        }
    )


def test_collection_resume_parity():
    rng = np.random.RandomState(6)
    preds, target = _epoch(rng, n_steps=8)
    mc_plain = _collection(mt, device="cpu")
    et.drive(mc_plain, (preds, target))
    store = MemoryStore()
    et.drive(_collection(mt, device="cpu"), (preds[:5], target[:5]), snapshot_store=store)
    mc_resume = _collection(mt, device="cpu")
    et.drive(mc_resume, (preds, target), resume_from=store)
    for key in ("acc", "confmat"):
        _assert_state_equal(mc_resume[key], mc_plain[key])
    plain_vals, resume_vals = mc_plain.compute(), mc_resume.compute()
    for key in plain_vals:
        assert torch.equal(resume_vals[key], plain_vals[key])


def test_disk_store_snapshot_round_trip(tmp_path):
    """Snapshots in a ``DiskStore`` load back through another store object
    on the same root, as a new process would."""
    rng = np.random.RandomState(7)
    preds, target = _epoch(rng, n_steps=6)
    m_full = mt.Accuracy(num_classes=NUM_CLASSES, device="cpu")
    et.drive(m_full, (preds, target))
    et.drive(
        mt.Accuracy(num_classes=NUM_CLASSES, device="cpu"), (preds[:4], target[:4]),
        snapshot_store=DiskStore(str(tmp_path / "snap")),
    )
    m_resume = mt.Accuracy(num_classes=NUM_CLASSES, device="cpu")
    et.drive(m_resume, (preds, target), resume_from=DiskStore(str(tmp_path / "snap")))
    _assert_state_equal(m_resume, m_full)


def test_snapshot_events_and_durability_stats():
    from metrics_tpu_torch.serving import durability_stats

    rng = np.random.RandomState(8)
    preds, target = _epoch(rng, n_steps=6)
    store = MemoryStore()
    before = durability_stats()
    with obs.capture() as events:
        et.drive(mt.Accuracy(num_classes=NUM_CLASSES, device="cpu"), (preds, target), snapshot_store=store, snapshot_every=2)
        et.drive(mt.Accuracy(num_classes=NUM_CLASSES, device="cpu"), (preds, target), resume_from=store)
    snaps = [e for e in events if e.kind == "snapshot"]
    assert len(snaps) == 3 and snaps[-1].data["final"]
    assert [e.data["step"] for e in snaps] == [2, 4, 6]
    assert any(e.kind == "recover" and e.data.get("scope") == "drive" for e in events)
    after = durability_stats()
    assert after["snapshots"] - before["snapshots"] == 3
    assert after["resumes"] - before["resumes"] == 1
    assert after["snapshot_bytes"] > before["snapshot_bytes"]


def test_resume_validation_errors():
    rng = np.random.RandomState(9)
    preds, target = _epoch(rng, n_steps=4)
    store = MemoryStore()
    et.drive(mt.Accuracy(num_classes=NUM_CLASSES, device="cpu"), (preds, target), snapshot_store=store)
    with pytest.raises(MetricsUserError, match="holds only 2 steps"):
        et.drive(mt.Accuracy(num_classes=NUM_CLASSES, device="cpu"), (preds[:2], target[:2]), resume_from=store)
    with pytest.raises(MetricsUserError, match="composition"):
        et.drive(
            mt.MetricCollection({"acc": mt.Accuracy(num_classes=NUM_CLASSES, device="cpu")}), (preds, target),
            resume_from=store,
        )
    with pytest.raises(MetricsUserError, match="different class or config"):
        et.drive(mt.ConfusionMatrix(num_classes=NUM_CLASSES, device="cpu"), (preds, target), resume_from=store)
    with pytest.raises(MetricsUserError, match="shape"):
        et.drive(mt.Accuracy(num_classes=NUM_CLASSES, average="macro", device="cpu"), (preds, target), resume_from=store)
    with pytest.raises(MetricsUserError, match="stream ended after 2 steps"):
        et.drive(
            mt.Accuracy(num_classes=NUM_CLASSES, device="cpu"), iter([(preds[i], target[i]) for i in range(2)]),
            resume_from=store,
        )
    with pytest.raises(KeyError, match="no drive snapshot"):
        driver.load_drive_snapshot(store, "elsewhere")


def test_snapshot_rejects_mesh_and_eager_members():
    rng = np.random.RandomState(10)
    preds, target = _epoch(rng, n_steps=4)
    store = MemoryStore()
    with pytest.raises(ValueError, match="LOCAL epoch path"):
        et.drive(
            mt.Accuracy(num_classes=NUM_CLASSES, device="cpu"), (preds, target), axis_name="batch", mesh=object(),
            snapshot_store=store,
        )
    scores = torch.from_numpy(np.random.RandomState(0).rand(4, 16).astype(np.float32))
    with pytest.raises(MetricsUserError, match="scan-drivable"):
        et.drive(mt.AUC(device="cpu"), (scores, scores), snapshot_store=store)
    with pytest.raises(ValueError, match="snapshot_every must be >= 1"):
        et.drive(mt.Accuracy(num_classes=NUM_CLASSES, device="cpu"), (preds, target), snapshot_store=store, snapshot_every=0)


# ---------------------------------------------------------------------------
# across the packages: the same sealed bytes
# ---------------------------------------------------------------------------
def test_jax_sealed_snapshot_resumes_the_port_drive():
    """A snapshot ``metrics_tpu.engine.drive`` sealed mid-epoch resumes the
    port's drive to the port's uninterrupted states bit for bit (and to the
    JAX package's uninterrupted epoch); the port seals the same bytes at the
    same boundary."""
    rng = np.random.RandomState(11)
    preds, target = _epoch(rng, n_steps=6)
    jstore = JMemoryStore()
    jdriver.drive(_collection(mj), (jnp.asarray(preds[:4].numpy()), jnp.asarray(target[:4].numpy())), snapshot_store=jstore)
    sealed = jstore.get("drive/drive")
    store = MemoryStore()
    et.drive(_collection(mt, device="cpu"), (preds[:4], target[:4]), snapshot_store=store)
    assert store.get("drive/drive") == sealed

    port_store = MemoryStore()
    port_store.put("drive/drive", sealed)
    mc_resume = _collection(mt, device="cpu")
    res = et.drive(mc_resume, (preds, target), resume_from=port_store)
    assert res.steps == 2
    mc_plain = _collection(mt, device="cpu")
    et.drive(mc_plain, (preds, target))
    j_plain = _collection(mj)
    jdriver.drive(j_plain, (jnp.asarray(preds.numpy()), jnp.asarray(target.numpy())))
    for key in ("acc", "confmat"):
        _assert_state_equal(mc_resume[key], mc_plain[key])
        _assert_like_jax(mc_resume[key], j_plain[key])
        assert mc_resume[key]._update_count == mc_plain[key]._update_count


def test_port_sealed_snapshot_resumes_the_jax_drive():
    """The reverse: the port's mid-epoch snapshot resumes the JAX package's
    drive to its uninterrupted epoch bit for bit."""
    rng = np.random.RandomState(12)
    preds, target = _epoch(rng, n_steps=6)
    store = MemoryStore()
    dead = iter([(preds[i], target[i]) for i in range(6)])
    gen, preempted = _interrupted(dead, die_after=5)
    with pytest.raises(preempted):
        et.drive(_collection(mt, device="cpu"), gen, steps_per_chunk=2, snapshot_store=store, snapshot_every=2)
    assert driver.load_drive_snapshot(store).step == 2  # the boundary at 4 was staged, not yet written
    jstore = JMemoryStore()
    jstore.put("drive/drive", store.get("drive/drive"))
    j_epoch = (jnp.asarray(preds.numpy()), jnp.asarray(target.numpy()))
    j_resume = _collection(mj)
    res = jdriver.drive(j_resume, j_epoch, resume_from=jstore)
    assert res.steps == 4
    j_plain = _collection(mj)
    jdriver.drive(j_plain, j_epoch)
    for key in ("acc", "confmat"):
        for name in j_plain[key]._defaults:
            np.testing.assert_array_equal(np.asarray(getattr(j_resume[key], name)), np.asarray(getattr(j_plain[key], name)))
    np.testing.assert_array_equal(np.asarray(j_resume.compute()["acc"]), np.asarray(j_plain.compute()["acc"]))


def test_forged_snapshot_fails_its_digest_on_resume():
    """``forge_snapshot_corruption`` keeps every crc valid and breaks one
    leaf's digest: the resume raises the integrity error naming the leaf,
    and the forged bytes are the JAX package's forge of the same snapshot."""
    from metrics_tpu.resilience.integrity import forge_snapshot_corruption as jforge
    from metrics_tpu_torch.resilience import forge_snapshot_corruption

    rng = np.random.RandomState(13)
    preds, target = _epoch(rng, n_steps=4)
    store = MemoryStore()
    et.drive(mt.ConfusionMatrix(num_classes=NUM_CLASSES, device="cpu"), (preds[:2], target[:2]), snapshot_store=store)
    sealed = store.get("drive/drive")
    forged = forge_snapshot_corruption(sealed, bit=3)
    assert forged == jforge(sealed, bit=3) and forged != sealed
    bad = MemoryStore()
    bad.put("drive/drive", forged)
    m = mt.ConfusionMatrix(num_classes=NUM_CLASSES, device="cpu")
    with pytest.raises(StateIntegrityError, match="confmat"):
        et.drive(m, (preds, target), resume_from=bad)
    assert m._update_count == 0


def _golden(family):
    with open(os.path.join(GOLDEN, "index.json")) as fh:
        return [e for e in json.load(fh)["artifacts"] if e["family"] == family]


@pytest.mark.parametrize("entry", _golden("snapshot"), ids=lambda e: e["file"])
def test_golden_snapshot_artifacts_decode_through_the_port_schema(entry):
    from metrics_tpu.resilience import schema as jschema
    from metrics_tpu_torch.resilience import schema
    from metrics_tpu_torch.utils.exceptions import SchemaVersionError

    with open(os.path.join(GOLDEN, entry["file"]), "rb") as fh:
        raw = fh.read()
    assert schema.registered_versions("snapshot") == jschema.registered_versions("snapshot") == [1]
    if entry["expect"] == "ok":
        got = schema.decode_any("snapshot", raw, context=" (golden)")
        want = jschema.decode_any("snapshot", raw, context=" (golden)")
        assert (got.step, got.final, sorted(got.states)) == (want.step, want.final, sorted(want.states))
        assert got.dynamics == want.dynamics
        for member, state in want.states.items():
            for name, value in state.items():
                np.testing.assert_array_equal(got.states[member][name].numpy(), np.asarray(value))
        return
    with pytest.raises(SchemaVersionError, match="NEWER build") as exc:
        schema.decode_any("snapshot", raw, context=" (golden)")
    assert (exc.value.family, exc.value.version, exc.value.current) == ("snapshot", 99, 1)

"""The port's driver (``metrics_tpu_torch.engine.drive``) and async results
plane (``compute_async``) against the per-step loop and the JAX package's
``engine.drive`` on the same numpy inputs, on the CPU: stacked epochs and
host iterables, ragged tails, health policies inside the chunk programs,
``compute_in_trace``, and one coalesced fetch per collection. It mirrors
``tests/engine/test_driver.py``.

Tolerances: integer states and counts bit for bit; float sums within 1e-5
relative against JAX (float64 x64 lane), bit for bit against the port's own
per-step loop.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mj
import metrics_tpu_torch as mt
from metrics_tpu import engine as ej
from metrics_tpu_torch import engine as et
from metrics_tpu_torch.engine import driver as td
from metrics_tpu_torch.utils.exceptions import NumericalHealthError

C = 5


@pytest.fixture(autouse=True)
def _fresh():
    ej.clear_cache()
    et.clear_cache()
    et.reset_fetch_stats()
    yield
    ej.clear_cache()
    et.clear_cache()


def _epoch(rng, n_steps=8, batch=16, c=C, nan_every=None):
    preds = rng.rand(n_steps, batch, c).astype(np.float32)
    target = rng.randint(0, c, size=(n_steps, batch)).astype(np.int64)
    if nan_every:
        for i in range(0, n_steps, nan_every):
            preds[i, :3, 0] = np.nan
    return preds, target


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _assert_state_equal(a, b):
    sa, sb = a._snapshot_state(), b._snapshot_state()
    assert set(sa) == set(sb)
    for name in sa:
        assert sa[name].dtype == sb[name].dtype and torch.equal(sa[name], sb[name]), name


def _assert_like_jax(port_v, jax_v, rtol=1e-6):
    p, j = port_v.numpy(), np.asarray(jax_v)
    assert p.shape == j.shape
    if j.dtype.kind in "iub":
        np.testing.assert_array_equal(p, j)
    else:
        np.testing.assert_allclose(p, j, rtol=rtol, atol=0)


def _loop(metric, preds, target):
    for i in range(preds.shape[0]):
        metric.update(*_t(preds[i], target[i]))


FACTORIES = {
    "accuracy": lambda pkg, **kw: pkg.Accuracy(num_classes=C, **kw),
    "stat_scores": lambda pkg, **kw: pkg.StatScores(reduce="macro", num_classes=C, **kw),
    "f1": lambda pkg, **kw: pkg.F1Score(num_classes=C, average="macro", **kw),
    "confmat": lambda pkg, **kw: pkg.ConfusionMatrix(num_classes=C, **kw),
}


@pytest.mark.parametrize("name", list(FACTORIES))
@pytest.mark.parametrize("k", [16, 3])
def test_stacked_epoch_equals_the_loop_and_jax(name, k):
    """A stacked epoch in K-step programs (one chunk, or 3+3+2 with a padded
    last chunk) equals the per-step loop bit for bit and JAX's drive."""
    rng = np.random.RandomState(0)
    preds, target = _epoch(rng)
    make = FACTORIES[name]
    m_drive, m_loop = make(mt, device="cpu"), make(mt, device="cpu")
    res = et.drive(m_drive, _t(preds, target), steps_per_chunk=k)
    assert res.steps == 8 and res.fused_keys == ("_",) and res.chunks == -(-8 // k)
    _loop(m_loop, preds, target)
    _assert_state_equal(m_drive, m_loop)
    assert m_drive._update_count == m_loop._update_count == 8
    jax_m = make(mj)
    ej.drive(jax_m, (jnp.asarray(preds), jnp.asarray(target)))
    _assert_like_jax(m_drive.compute(), jax_m.compute())


@pytest.mark.parametrize("cls", ["SumMetric", "MeanMetric"])
def test_aggregation_epochs(cls):
    rng = np.random.RandomState(1)
    xs = rng.rand(6, 32).astype(np.float32)
    m_drive, m_loop = (getattr(mt, cls)(nan_strategy="disable", device="cpu") for _ in range(2))
    res = et.drive(m_drive, _t(xs))
    assert res.fused_keys == ("_",)
    for i in range(6):
        m_loop.update(torch.from_numpy(xs[i]))
    _assert_state_equal(m_drive, m_loop)
    jax_m = getattr(mj, cls)(nan_strategy="disable")
    ej.drive(jax_m, (jnp.asarray(xs),))
    _assert_like_jax(m_drive.compute(), jax_m.compute(), rtol=1e-5)


@pytest.mark.parametrize("case", ["legacy_warn", "list_state", "raise_policy"])
def test_members_a_chunk_cannot_carry_go_per_step(case):
    rng = np.random.RandomState(2)
    if case == "raise_policy":
        preds, target = _epoch(rng, nan_every=2)
        m = mt.Accuracy(num_classes=C, on_bad_input="raise", device="cpu")
        with pytest.raises(NumericalHealthError):
            et.drive(m, _t(preds, target))
        return
    if case == "legacy_warn":
        xs = rng.rand(4, 8).astype(np.float32)
        m, m2 = mt.MeanMetric(device="cpu"), mt.MeanMetric(device="cpu")
        res = et.drive(m, _t(xs))
        for i in range(4):
            m2.update(torch.from_numpy(xs[i]))
    else:
        x, y = rng.rand(5, 16).astype(np.float32), rng.rand(5, 16).astype(np.float32)
        m, m2 = mt.AUROC(device="cpu"), mt.AUROC(device="cpu")
        steps = [(torch.from_numpy(x[i]), torch.from_numpy((y[i] > 0.5).astype(np.int64))) for i in range(5)]
        res = et.drive(m, iter(steps))
        for s in steps:
            m2.update(*s)
    assert res.fused_keys == () and res.eager_keys == ("_",)
    assert torch.equal(m.compute(), m2.compute())


def test_streaming_ragged_last_batch_equals_the_loop_and_jax():
    rng = np.random.RandomState(5)
    preds, target = _epoch(rng, n_steps=9, batch=16)
    steps = [(preds[i], target[i]) for i in range(9)] + [(preds[0][:5], target[0][:5])]
    m_drive, m_loop = mt.Accuracy(num_classes=C, device="cpu"), mt.Accuracy(num_classes=C, device="cpu")
    res = et.drive(m_drive, iter(_t(*s) for s in steps), steps_per_chunk=4)
    assert res.steps == 10 and res.chunks == 3
    for s in steps:
        m_loop.update(*_t(*s))
    _assert_state_equal(m_drive, m_loop)
    assert m_drive._update_count == 10
    jax_m = mj.Accuracy(num_classes=C)
    ej.drive(jax_m, iter((jnp.asarray(p), jnp.asarray(t)) for p, t in steps), steps_per_chunk=4)
    _assert_like_jax(m_drive.compute(), jax_m.compute())


def test_streaming_matches_stacked():
    rng = np.random.RandomState(6)
    preds, target = _epoch(rng, n_steps=12, batch=8)
    stacked, streamed = mt.Accuracy(num_classes=C, device="cpu"), mt.Accuracy(num_classes=C, device="cpu")
    et.drive(stacked, _t(preds, target))
    et.drive(streamed, iter(_t(preds[i], target[i]) for i in range(12)), steps_per_chunk=5)
    _assert_state_equal(stacked, streamed)


@pytest.mark.parametrize("policy", ["skip", "mask"])
def test_health_policies_inside_the_chunks(policy):
    rng = np.random.RandomState(7)
    preds, target = _epoch(rng, nan_every=3)
    m_drive = mt.Accuracy(num_classes=C, on_bad_input=policy, device="cpu")
    m_loop = mt.Accuracy(num_classes=C, on_bad_input=policy, device="cpu")
    res = et.drive(m_drive, _t(preds, target))
    assert res.fused_keys == ("_",)
    _loop(m_loop, preds, target)
    _assert_state_equal(m_drive, m_loop)
    jax_m = mj.Accuracy(num_classes=C, on_bad_input=policy)
    ej.drive(jax_m, (jnp.asarray(preds), jnp.asarray(target)))
    got, want = m_drive.health_report(), jax_m.health_report()
    for key in ("nan_count", "rows_masked", "updates_quarantined", "batches_screened"):
        assert got[key] == m_loop.health_report()[key] == want[key], key
    _assert_like_jax(m_drive.compute(), jax_m.compute())


def _collection(pkg, **kw):
    return pkg.MetricCollection(
        {
            "acc": pkg.Accuracy(num_classes=C, **kw),
            "cm": pkg.ConfusionMatrix(num_classes=C, **kw),
            "f1": pkg.F1Score(num_classes=C, average="macro", **kw),
        }
    )


@pytest.mark.parametrize("compute_in_trace", [False, True])
def test_collection_epochs_equal_the_loop_and_jax(compute_in_trace):
    rng = np.random.RandomState(9)
    preds, target = _epoch(rng)
    mc_drive, mc_loop = _collection(mt, device="cpu"), _collection(mt, device="cpu")
    res = et.drive(mc_drive, _t(preds, target), compute_in_trace=compute_in_trace)
    assert set(res.fused_keys) == {"acc", "cm", "f1"}
    for i in range(8):
        mc_loop.update(*_t(preds[i], target[i]))
    jax_mc = _collection(mj)
    jax_res = ej.drive(jax_mc, (jnp.asarray(preds), jnp.asarray(target)), compute_in_trace=compute_in_trace)
    out, want = mc_drive.compute(), jax_mc.compute()
    if compute_in_trace:
        assert set(res.values) == set(jax_res.values) == {"acc", "cm", "f1"}
        for k in out:
            assert torch.equal(res.values[k], out[k])
    for k, v in mc_loop.compute().items():
        assert torch.equal(out[k], v)
        _assert_like_jax(out[k], want[k])


def test_mixed_members_split():
    rng = np.random.RandomState(10)
    preds, target = rng.rand(4, 8).astype(np.float32), rng.rand(4, 8).astype(np.float32)
    mc = mt.MetricCollection({"auc": mt.AUC(device="cpu"), "mean": mt.MeanMetric(nan_strategy="disable", device="cpu")})
    res = et.drive(mc, _t(preds, target))
    assert "auc" in res.eager_keys and "mean" in res.fused_keys


def test_one_program_per_chunk_signature():
    rng = np.random.RandomState(11)
    preds, target = _epoch(rng, n_steps=8, batch=16)
    m1 = mt.Accuracy(num_classes=C, device="cpu")
    et.drive(m1, _t(preds, target))
    first = et.cache_summary()["by_kind"]["driver"]
    et.drive(m1, _t(preds, target))
    et.drive(mt.Accuracy(num_classes=C, device="cpu"), _t(preds, target))
    after = et.cache_summary()["by_kind"]["driver"]
    assert after["compiles"] == first["compiles"] == 1 and after["entries"] == 1
    et.drive(mt.Accuracy(num_classes=C, device="cpu"), _t(preds[:5], target[:5]))
    assert et.cache_summary()["by_kind"]["driver"]["compiles"] == 2


def test_compute_in_trace_matches_host_compute():
    rng = np.random.RandomState(12)
    preds, target = _epoch(rng)
    m_a, m_b = mt.Accuracy(num_classes=C, device="cpu"), mt.Accuracy(num_classes=C, device="cpu")
    res = et.drive(m_a, _t(preds, target), compute_in_trace=True)
    et.drive(m_b, _t(preds, target))
    assert torch.equal(res.values, m_b.compute()) and torch.equal(m_a.compute(), m_b.compute())


@pytest.mark.parametrize("empty", ["iterator", "stacked"])
def test_empty_epochs_still_report_values(empty):
    rng = np.random.RandomState(21)
    preds, target = _epoch(rng, n_steps=4, batch=8)
    m = mt.Accuracy(num_classes=C, device="cpu")
    et.drive(m, _t(preds, target))
    want = m.compute()
    batches = iter(()) if empty == "iterator" else _t(preds[:0], target[:0])
    res = et.drive(m, batches, compute_in_trace=True)
    assert res.steps == 0 and res.chunks == 0 and torch.equal(res.values, want)


@pytest.mark.parametrize("collate", ["scalars", "tuple_of_tuples", "lists"])
def test_step_forms_stream(collate):
    rng = np.random.RandomState(14)
    if collate == "scalars":
        vals = [torch.arange(4.0) + i for i in range(6)]
        weights = [0.5, 2.0, 1.0, 0.25, 3.0, 1.5]
        a, b = mt.MeanMetric(nan_strategy="disable", device="cpu"), mt.MeanMetric(nan_strategy="disable", device="cpu")
        res = et.drive(a, iter(zip(vals, weights)), steps_per_chunk=3)
        for v, w in zip(vals, weights):
            b.update(v, w)
        assert res.steps == 6 and res.chunks == 2
        torch.testing.assert_close(a.compute(), b.compute(), rtol=1e-6, atol=0)
        return
    preds, target = _epoch(rng, n_steps=5, batch=8)
    steps = [_t(preds[i], target[i]) for i in range(5)]
    batches = tuple(steps) if collate == "tuple_of_tuples" else [list(s) for s in steps]
    m_drive, m_loop = mt.Accuracy(num_classes=C, device="cpu"), mt.Accuracy(num_classes=C, device="cpu")
    res = et.drive(m_drive, batches, steps_per_chunk=2)
    assert res.steps == 5
    _loop(m_loop, preds, target)
    _assert_state_equal(m_drive, m_loop)


def test_partial_final_chunk_pads_only_within_its_family(monkeypatch):
    """Whole zero steps pad a short last chunk only to replay the K-step
    program of its own shape; after a shape break the short chunk runs at
    its natural length."""
    recorded = []
    dispatch = td._ChunkRunner._dispatch

    def spy(self, leaves, pads, last):
        recorded.append((int(leaves[0].shape[0]), None if pads is None else list(pads)))
        return dispatch(self, leaves, pads, last)

    monkeypatch.setattr(td._ChunkRunner, "_dispatch", spy)

    def run(steps, k=4):
        recorded.clear()
        m, loop = mt.Accuracy(num_classes=C, device="cpu"), mt.Accuracy(num_classes=C, device="cpu")
        et.drive(m, iter(steps), steps_per_chunk=k)
        for s in steps:
            loop.update(*s)
        _assert_state_equal(m, loop)
        return list(recorded)

    def steps(n, batch):
        rng = np.random.RandomState(batch)
        return [_t(rng.rand(batch, C).astype(np.float32), rng.randint(0, C, size=(batch,))) for _ in range(n)]

    assert run(steps(3, 4) + steps(3, 8)) == [(3, None), (3, None)]
    assert run(steps(6, 8)) == [(4, None), (4, [0, 0, 8, 8])]
    assert run(steps(4, 8) + steps(2, 16)) == [(4, None), (2, None)]


def test_streaming_dispatches_each_chunk_as_it_fills():
    m = mt.Accuracy(num_classes=C, device="cpu")
    rng = np.random.RandomState(3)
    steps = [_t(rng.rand(8, C).astype(np.float32), rng.randint(0, C, size=(8,))) for _ in range(6)]
    calls_at_yield = []

    def instrumented():
        for i, s in enumerate(steps):
            calls_at_yield.append((i, et.cache_summary()["calls"]))
            yield s

    res = et.drive(m, instrumented(), steps_per_chunk=2)
    assert res.steps == 6 and res.chunks == 3
    calls = dict(calls_at_yield)
    assert calls[3] > calls[0]


@pytest.mark.parametrize(
    "kwargs",
    [
        {"mesh": object()},
        {"axis_name": "dp"},
        {"in_specs": ()},
        {"hierarchical_sync": True},
        {"snapshot_store": "memory", "mesh": object(), "axis_name": "dp"},
        {"resume_from": "memory"},
        {"snapshot_store": "memory", "snapshot_every": 0},
    ],
    ids=["mesh", "axis_name", "in_specs", "hierarchical_sync", "snapshot_store", "resume_from", "snapshot_every"],
)
def test_modes_of_later_slices_raise_not_implemented(kwargs):
    from metrics_tpu_torch.serving import MemoryStore

    m = mt.SumMetric(nan_strategy="disable", device="cpu")
    if set(kwargs) & {"snapshot_store", "resume_from"}:
        # the drive snapshots are ported (tests/test_torch_drive_resume.py):
        # the JAX package's validation errors, as test_drive_resume.py's
        # test_resume_validation_errors and test_snapshot_rejects_mesh_and_eager_members
        kwargs = {k: MemoryStore() if v == "memory" else v for k, v in kwargs.items()}
        expect = {
            "mesh": (ValueError, "LOCAL epoch path"),
            "resume_from": (KeyError, "no drive snapshot"),
            "snapshot_every": (ValueError, "snapshot_every must be >= 1"),
        }
        err, match = next(v for k, v in expect.items() if k in kwargs)
        with pytest.raises(err, match=match):
            et.drive(m, (torch.ones(2, 3),), **kwargs)
    else:
        # the mesh modes are ported (tests/test_torch_mesh.py): an incomplete
        # set of their arguments raises the JAX package's errors
        with pytest.raises(ValueError, match="mesh|MULTI-axis"):
            et.drive(m, (torch.ones(2, 3),), **kwargs)
    with pytest.raises(ValueError, match="steps_per_chunk"):
        et.drive(m, (torch.ones(2, 3),), steps_per_chunk=0)


# ---------------------------------------------------------------------------
# async results
# ---------------------------------------------------------------------------
def test_compute_async_is_one_fetch_equal_to_compute():
    rng = np.random.RandomState(13)
    preds, target = _epoch(rng)
    mc = _collection(mt, device="cpu")
    et.drive(mc, _t(preds, target))
    et.reset_fetch_stats()
    handle = mc.compute_async()
    got = handle.result()
    stats = et.fetch_stats()
    assert stats["async_fetches"] == 1 and stats["coalesced_leaves"] == len(got)
    blocking = mc.compute()
    jax_mc = _collection(mj)
    ej.drive(jax_mc, (jnp.asarray(preds), jnp.asarray(target)))
    jax_got = jax_mc.compute_async().result()
    assert set(got) == set(blocking) == set(jax_got)
    for k in got:
        assert torch.equal(got[k], blocking[k])
        _assert_like_jax(got[k], jax_got[k])
    handle.result()
    assert et.fetch_stats()["async_fetches"] == 1


def test_compute_async_of_a_metric_repr_and_release():
    m = mt.SumMetric(nan_strategy="disable", device="cpu")
    m.update(torch.tensor([1.0, 2.0]))
    handle = m.compute_async()
    assert "AsyncResult" in repr(handle) and "pending" not in repr(handle)
    first = handle.result()
    assert handle._tree is None and handle.ready() and torch.equal(first, m.compute())
    assert "resolved" in repr(handle)


def test_compute_async_concurrent_resolution_is_one_fetch():
    m = mt.SumMetric(nan_strategy="disable", device="cpu")
    m.update(torch.tensor([4.0, 5.0]))
    handle = m.compute_async()
    et.reset_fetch_stats()
    results, barrier = [None] * 8, threading.Barrier(8)

    def resolve(i):
        barrier.wait()
        results[i] = handle.result()

    threads = [threading.Thread(target=resolve, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert et.fetch_stats()["async_fetches"] == 1
    assert all(r is results[0] for r in results)

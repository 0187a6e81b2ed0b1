"""The port's observability layer (``metrics_tpu_torch.obs``) on the CPU,
mirroring ``tests/obs/`` (the bus, the spans, the retrace explainer,
``warn_once`` and the snapshot reports) against ``metrics_tpu_torch``, and
held against ``metrics_tpu`` on the same seeded numpy inputs, each package
with its own bus enabled:

* the kinds of engine and lifecycle events of an exact-shape and a
  pow2-bucketed stream (the JAX package may make one extra compile on the
  bucketed stream: a weakly typed fresh state, the same allowance as
  ``tests/test_torch_engine.py``);
* the ``explain`` components a bucket, a shape and a dtype change name;
* the nested key sets of ``obs_snapshot()`` and ``sync_report()``;
* JSONL written by either package validating under the other;
* the Prometheus families the port renders for a collection, each also in
  the JAX rendering, with the same ``member`` labels.

It also holds what only the port has: a Python scalar keys a program by
value, so its retrace is named under ``avals``; a disabled bus builds no
event anywhere on the lifecycle; and, across two gloo ranks run by this
file as its own worker, each rank's ``sync_report()`` counts its syncs,
gathers and bytes. Every event field compared is an exact count or name.
"""
import copy
import io
import os
import pickle
import socket
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_CLASSES = 3
WORKER_TIMEOUT_S = 120
ENGINE_KINDS = ("compile", "cache_hit", "retrace", "bucketed", "update", "forward", "compute", "sync")

_rng = np.random.RandomState(42)
_P_NP = _rng.rand(16, NUM_CLASSES).astype(np.float32)
_T_NP = _rng.randint(0, NUM_CLASSES, size=(16,)).astype(np.int64)
_P = torch.from_numpy(_P_NP)
_T = torch.from_numpy(_T_NP)


def _port():
    import metrics_tpu_torch as mt

    return mt


def _jax():
    import metrics_tpu as mj

    return mj


def _quiet(obs_mod):
    obs_mod.disable()
    obs_mod.disable_tracing()
    obs_mod.bus.clear()
    obs_mod.trace.clear()


@pytest.fixture(autouse=True)
def _quiet_obs():
    """Every case starts from a quiet process in both packages: bus and
    tracing off, empty buffers and aggregates, empty program caches,
    re-armed warnings; restored on exit too."""
    mt = _port()
    from metrics_tpu_torch.obs.warn import reset_warn_once

    mj = _jax()
    for pkg in (mt, mj):
        _quiet(pkg.obs)
        pkg.engine.clear_cache()
    reset_warn_once()
    yield
    for pkg in (mt, mj):
        _quiet(pkg.obs)
        pkg.engine.clear_cache()
    reset_warn_once()


def members(pkg=None):
    pkg = pkg or _port()
    kw = {"device": "cpu"} if pkg is _port() else {}
    return {
        "acc": pkg.Accuracy(num_classes=NUM_CLASSES, **kw),
        "confmat": pkg.ConfusionMatrix(num_classes=NUM_CLASSES, **kw),
        "f1": pkg.F1Score(num_classes=NUM_CLASSES, average="macro", **kw),
    }


def assert_snapshot_matches_reports(metric):
    """The sections of a snapshot are the legacy reports."""
    snap = metric.obs_snapshot()
    assert snap["compile"] == metric.compile_stats()
    assert snap["sync"] == metric.sync_report()
    assert snap["health"] == metric.health_report()
    assert snap["class"] == type(metric).__name__


# ---------------------------------------------------------------------------
# the bus (tests/obs/test_bus.py)
# ---------------------------------------------------------------------------
def test_disabled_emit_is_none_and_records_nothing():
    obs = _port().obs
    assert not obs.enabled()
    assert obs.emit("compile", source="x") is None
    assert obs.events() == []
    assert obs.bus.summary()["emitted_total"] == 0


def test_emit_and_events_roundtrip():
    obs = _port().obs
    obs.enable()
    e = obs.emit("compile", source="Accuracy", variant="exact", traces=1)
    assert e is not None and e.kind == "compile" and e.source == "Accuracy"
    assert e.data == {"variant": "exact", "traces": 1}
    evs = obs.events()
    assert [x.seq for x in evs] == [e.seq]
    assert obs.events("compile") == evs
    assert obs.events("retrace") == []


def test_unknown_kind_raises_even_when_enabled():
    obs = _port().obs
    obs.enable()
    with pytest.raises(ValueError, match="Unknown obs event kind"):
        obs.emit("not_a_kind", source="x")


def test_seq_monotonic_and_counts_by_kind():
    obs = _port().obs
    obs.enable()
    for _ in range(3):
        obs.emit("cache_hit", source="m")
    obs.emit("retrace", source="m")
    seqs = [e.seq for e in obs.events()]
    assert seqs == sorted(seqs) and len(set(seqs)) == 4
    summary = obs.bus.summary()
    assert summary["by_kind"] == {"cache_hit": 3, "retrace": 1}
    assert summary["emitted_total"] == 4
    assert summary["enabled"] is True


def test_ring_buffer_bounded_and_drops_counted():
    obs = _port().obs
    obs.enable()
    obs.bus.set_capacity(16)
    try:
        for i in range(20):
            obs.emit("warning", source="w", i=i)
        summary = obs.bus.summary()
        assert summary["buffered"] == 16
        assert summary["dropped"] == 4
        assert summary["by_kind"]["warning"] == 20  # totals survive eviction
        assert [e.data["i"] for e in obs.events()] == list(range(4, 20))
    finally:
        obs.bus.set_capacity(4096)


def test_subscriber_sees_events_and_errors_never_break_emitter():
    obs = _port().obs
    obs.enable()
    seen = []

    def bad(_event):
        raise RuntimeError("subscriber bug")

    obs.subscribe(seen.append)
    obs.subscribe(bad)
    try:
        obs.emit("compile", source="m")
        obs.emit("compute", source="m")
    finally:
        obs.unsubscribe(seen.append)
        obs.unsubscribe(bad)
    assert [e.kind for e in seen] == ["compile", "compute"]
    assert obs.bus.summary()["subscriber_errors"] == 2


def test_capture_restores_previous_enabled_state():
    obs = _port().obs
    assert not obs.enabled()
    with obs.capture() as events:
        assert obs.enabled()
        obs.emit("compile", source="m")
    assert not obs.enabled()
    assert [e.kind for e in events] == ["compile"]
    obs.enable()
    with obs.capture(kinds=("retrace",)) as events:
        obs.emit("compile", source="m")
        obs.emit("retrace", source="m")
    assert obs.enabled()
    assert [e.kind for e in events] == ["retrace"]


def test_concurrent_emit_never_tears():
    obs = _port().obs
    obs.enable()

    def hammer(k):
        for _ in range(200):
            obs.emit("cache_hit", source=f"t{k}")

    threads = [threading.Thread(target=hammer, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert obs.bus.summary()["by_kind"]["cache_hit"] == 800
    seqs = [e.seq for e in obs.events()]
    assert len(set(seqs)) == len(seqs)


def test_clear_zeroes_counters_but_keeps_enabled_flag():
    obs = _port().obs
    obs.enable()
    obs.emit("compile", source="m")
    obs.bus.clear()
    assert obs.enabled()
    assert obs.events() == []
    assert obs.bus.summary()["emitted_total"] == 0


# ---------------------------------------------------------------------------
# spans (tests/obs/test_spans.py)
# ---------------------------------------------------------------------------
def test_inactive_span_machinery_is_off_by_default():
    trace = _port().obs.trace
    assert not trace.active()
    assert trace.span_summary() == {}


def test_span_records_aggregates():
    obs = _port().obs
    obs.enable_tracing()
    for _ in range(2):
        with obs.trace.span("compute", "Demo"):
            pass
    agg = obs.trace.span_summary()["compute"]["Demo"]
    assert agg["count"] == 2
    assert agg["total_s"] >= agg["max_s"] >= agg["min_s"] >= 0.0
    assert agg["mean_s"] == pytest.approx(agg["total_s"] / 2)
    assert agg["fenced"] is False


def test_span_emits_bus_event_and_flags_errors():
    obs = _port().obs
    obs.enable()
    with pytest.raises(RuntimeError):
        with obs.trace.span("update", "Demo"):
            raise RuntimeError("boom")
    (event,) = obs.events("update")
    assert event.source == "Demo"
    assert event.data["error"] is True
    assert event.data["duration_s"] >= 0.0


def test_fenced_span_blocks_on_payload():
    obs = _port().obs
    obs.enable_tracing(fence=True)
    assert obs.trace.fence_enabled()
    fetched = []
    with obs.trace.span("update", "Demo", payload=lambda: fetched.append(1) or {"s": [torch.zeros(())]}):
        pass
    assert fetched == [1]
    # a CPU payload is fenced as block_until_ready fences CPU arrays: a no-op that reports it
    assert obs.trace.span_summary()["update"]["Demo"]["fenced"] is True
    obs.disable_tracing()
    obs.enable_tracing(fence=False)
    with obs.trace.span("update", "Demo2", payload=lambda: fetched.append(2)):
        pass
    assert fetched == [1]
    assert obs.trace.span_summary()["update"]["Demo2"]["fenced"] is False


def test_metric_lifecycle_phases_recorded():
    mt = _port()
    mt.obs.enable_tracing()
    acc = mt.Accuracy(num_classes=NUM_CLASSES, device="cpu")
    acc.update(_P[:2], _T[:2])
    acc.compute()
    acc(_P[:2], _T[:2])
    summary = mt.obs.span_summary()
    assert summary["update"]["Accuracy"]["count"] == 2  # the forward's batch update is one
    assert summary["compute"]["Accuracy"]["count"] == 2
    assert summary["forward"]["Accuracy"]["count"] == 1


def test_collection_lifecycle_phases_recorded():
    mt = _port()
    mt.obs.enable_tracing()
    mc = mt.MetricCollection({"acc": mt.Accuracy(num_classes=NUM_CLASSES, device="cpu")})
    mc.update(_P[:2], _T[:2])
    mc.compute()
    mc.forward(_P[:2], _T[:2])
    summary = mt.obs.span_summary()
    assert summary["update"]["MetricCollection"]["count"] == 1
    assert summary["compute"]["MetricCollection"]["count"] == 1
    assert summary["forward"]["MetricCollection"]["count"] == 1


def test_disabled_tracing_adds_no_spans_around_lifecycle():
    mt = _port()
    acc = mt.Accuracy(num_classes=NUM_CLASSES, device="cpu")
    acc.update(_P[:2], _T[:2])
    acc.compute()
    assert mt.obs.span_summary() == {}


# ---------------------------------------------------------------------------
# the retrace explainer (tests/obs/test_explain.py)
# ---------------------------------------------------------------------------
class _Leaf:
    def __init__(self, shape, dtype):
        self.shape = shape
        self.dtype = dtype


def _sig(shapes_dtypes, **kw):
    return _port().obs.explain.signature([_Leaf(s, d) for s, d in shapes_dtypes], **kw)


def test_no_prior_signature_is_honestly_unknown():
    verdict = _port().obs.explain.diff(None, _sig([((4,), "f32")]))
    assert verdict["changed"] == ["unknown"]
    assert "no prior dispatch signature" in verdict["detail"]


def test_aval_change_named_per_leaf():
    verdict = _port().obs.explain.diff(_sig([((4, 3), "f32"), ((4,), "i32")]), _sig([((8, 3), "f32"), ((8,), "i32")]))
    assert verdict["changed"] == ["avals"]
    assert "leaf0: (4, 3) -> (8, 3)" in verdict["detail"]
    assert "leaf1: (4,) -> (8,)" in verdict["detail"]


def test_dtype_bucket_donation_screening_changes_named():
    diff = _port().obs.explain.diff
    base = dict(bucket=8, donate=True, screening=("propagate",))
    prev = _sig([((4,), "float32")], **base)
    assert diff(prev, _sig([((4,), "float64")], **base))["changed"] == ["dtype"]
    assert diff(prev, _sig([((4,), "float32")], bucket=16, donate=True, screening=("propagate",)))["changed"] == ["bucket"]
    assert diff(prev, _sig([((4,), "float32")], bucket=8, donate=False, screening=("propagate",)))["changed"] == ["donation"]
    assert diff(prev, _sig([((4,), "float32")], bucket=8, donate=True, screening=("skip",)))["changed"] == ["screening"]


def test_structure_change_reported_alone():
    verdict = _port().obs.explain.diff(_sig([((4,), "f32")]), _sig([((4,), "f32"), ((4,), "f32")]))
    assert verdict["changed"] == ["structure"]


def test_identical_signature_is_honestly_unknown():
    sig = _sig([((4,), "f32")])
    verdict = _port().obs.explain.diff(sig, dict(sig))
    assert verdict["changed"] == ["unknown"]
    assert "device" in verdict["detail"]


def test_tensor_dtype_drift_visible_in_dtype_component():
    explain = _port().obs.explain
    verdict = explain.diff(explain.signature([torch.zeros(4, dtype=torch.int32)]), explain.signature([torch.zeros(4, dtype=torch.int64)]))
    assert verdict["changed"] == ["dtype"]
    assert "torch.int32 -> torch.int64" in verdict["detail"]


def _cls_batch(rng, n):
    return torch.from_numpy(rng.rand(n, NUM_CLASSES).astype(np.float32)), torch.from_numpy(
        rng.randint(0, NUM_CLASSES, size=(n,)).astype(np.int64)
    )


def test_live_bucket_retrace_event_names_bucket_and_avals():
    mt = _port()
    mt.obs.enable()
    acc = mt.Accuracy(num_classes=NUM_CLASSES, jit_bucket="pow2", device="cpu")
    rng = np.random.RandomState(0)
    acc.update(*_cls_batch(rng, 4))
    acc.update(*_cls_batch(rng, 4))
    mt.obs.bus.clear()
    acc.update(*_cls_batch(rng, 7))  # bucket 8: a new program
    (retrace,) = mt.obs.events("retrace")
    verdict = retrace.data["explain"]
    assert "bucket" in verdict["changed"] and "avals" in verdict["changed"]
    assert retrace.source == "Accuracy"
    (bucketed,) = mt.obs.events("bucketed")
    assert bucketed.data == {"batch": 7, "pad": 1, "bucket": 8}


def test_live_repeat_dispatch_is_a_cache_hit_not_a_retrace():
    """The port has no weak types: the second update of the same shapes is
    a cache hit (the JAX package may retrace once there, on ``dtype``)."""
    mt = _port()
    mt.obs.enable()
    acc = mt.Accuracy(num_classes=NUM_CLASSES, jit_bucket="pow2", device="cpu")
    acc.update(_P[:2], _T[:2])
    mt.obs.bus.clear()
    acc.update(_P[:2], _T[:2])
    assert mt.obs.events("retrace") == []
    assert len(mt.obs.events("cache_hit")) == 1


def test_every_engine_retrace_carries_an_explainer():
    mt = _port()
    mt.obs.enable()
    acc = mt.Accuracy(num_classes=NUM_CLASSES, jit_bucket="pow2", device="cpu")
    rng = np.random.RandomState(1)
    for n in (3, 3, 5, 9, 17, 33):
        acc.update(*_cls_batch(rng, n))
    retraces = mt.obs.events("retrace")
    assert len(retraces) == 4  # buckets 8, 16, 32, 64 after 4
    for event in retraces:
        verdict = event.data.get("explain")
        assert verdict and verdict["changed"] and verdict["changed"] != ["unknown"], event


def test_scalar_keyed_retrace_is_named_under_avals():
    """A Python scalar is part of the program key by value (a CUDA graph
    bakes it in): ``weight=2.0`` then ``3.0`` is a retrace, named ``avals``."""
    mt = _port()
    mt.obs.enable()
    m = mt.MeanMetric(nan_strategy="disable", device="cpu")
    x = torch.arange(4, dtype=torch.float32)
    m.update(x, weight=2.0)
    m.update(x, weight=2.0)
    m.update(x, weight=3.0)
    kinds = [e.kind for e in mt.obs.events() if e.kind in ("compile", "cache_hit", "retrace")]
    assert kinds == ["compile", "cache_hit", "retrace"]
    verdict = mt.obs.events("retrace")[0].data["explain"]
    assert verdict["changed"] == ["avals"]
    assert "py:2.0 -> py:3.0" in verdict["detail"]
    assert float(m.compute()) == pytest.approx(float((x * 2).sum() + (x * 2).sum() + (x * 3).sum()) / 28.0)


# ---------------------------------------------------------------------------
# warn_once (tests/obs/test_warn_once.py)
# ---------------------------------------------------------------------------
def test_warn_once_dedups_per_key():
    from metrics_tpu_torch.obs.warn import seen_count, warn_once

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert warn_once("hello", key="k") is True
        assert warn_once("hello", key="k") is False
        assert warn_once("hello", key="k") is False
    assert len(w) == 1 and "hello" in str(w[0].message)
    assert seen_count("k") == 3


def test_default_key_is_message_and_category():
    from metrics_tpu_torch.obs.warn import warn_counts, warn_once

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        warn_once("msg a")
        warn_once("msg a")
        warn_once("msg b")
        warn_once("msg a", category=DeprecationWarning)
    assert [str(x.message) for x in w] == ["msg a", "msg b", "msg a"]
    assert warn_counts()[("msg a", "UserWarning")] == 2


def test_reset_rearms_one_key_or_all():
    from metrics_tpu_torch.obs.warn import reset_warn_once, warn_counts, warn_once

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        warn_once("again", key="k1")
        warn_once("other", key="k2")
        reset_warn_once("k1")
        warn_once("again", key="k1")
        warn_once("other", key="k2")
    assert [str(x.message) for x in w] == ["again", "other", "again"]
    reset_warn_once()
    assert warn_counts() == {}


def test_first_emission_lands_on_bus_with_repeat_count():
    mt = _port()
    mt.obs.enable()
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        mt.obs.warn_once("streamed", key="bk")
        mt.obs.warn_once("streamed", key="bk")
    (event,) = mt.obs.events("warning")
    assert event.data["message"] == "streamed"
    assert event.data["repeat"] == 0


def test_env_escape_hatch_disables_dedup(monkeypatch):
    from metrics_tpu_torch.obs.warn import warn_once

    monkeypatch.setenv("METRICS_TPU_WARN_EVERY", "1")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        warn_once("every time", key="e")
        warn_once("every time", key="e")
    assert len(w) == 2


def test_off_rank_process_is_silent_but_counted(monkeypatch):
    from metrics_tpu_torch.obs import warn as warn_mod

    monkeypatch.setattr(warn_mod, "_rank", lambda: 1)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert warn_mod.warn_once("rank gated", key="r") is False
    assert w == []
    assert warn_mod.seen_count("r") == 1


def test_compute_before_update_warns_once_per_instance():
    mt = _port()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        mse = mt.MeanSquaredError(device="cpu")
        mse.compute()
        mse._computed = None
        mse.compute()  # same instance: deduplicated
        mt.MeanSquaredError(device="cpu").compute()  # a sibling warns for itself
        with pytest.raises(RuntimeError):
            mt.Accuracy(num_classes=NUM_CLASSES, device="cpu").compute()
    msgs = [str(x.message) for x in w if "was called before" in str(x.message)]
    assert sum("MeanSquaredError" in m for m in msgs) == 2
    assert sum("Accuracy" in m for m in msgs) == 1


# ---------------------------------------------------------------------------
# snapshots and the legacy reports (tests/obs/test_snapshot_reports.py)
# ---------------------------------------------------------------------------
def test_snapshot_bit_consistent_with_legacy_reports():
    mt = _port()
    acc = mt.Accuracy(num_classes=NUM_CLASSES, device="cpu")
    acc.update(_P, _T)
    acc.compute()
    assert_snapshot_matches_reports(acc)
    assert mt.obs.snapshot(acc) == acc.obs_snapshot()


def test_snapshot_requires_a_report_surface():
    with pytest.raises(TypeError, match="obs_snapshot"):
        _port().obs.snapshot(42)


def test_collection_snapshot_covers_every_member_in_one_call():
    mt = _port()
    mc = mt.MetricCollection(members())
    mc.update(_P, _T)
    mc.compute()
    snap = mt.obs.snapshot(mc)
    assert snap == mc.obs_snapshot()
    assert set(snap["members"]) == {"acc", "confmat", "f1"}
    for key, m in mc.items():
        member = snap["members"][key]
        assert member["compile"] == m.compile_stats()
        assert member["sync"] == m.sync_report()
        assert member["health"] == m.health_report()
    assert snap["fused_compile"] == {k: v for k, v in mc.compile_stats().items() if k != "members"}
    assert snap["fused_compile"]["compiles"] + snap["fused_compile"]["cache_hits"] >= 1
    assert snap["sync"] == {k: v for k, v in mc.sync_report().items() if k != "members"}
    assert snap["health"] == {k: v for k, v in mc.health_report().items() if k != "members"}


def test_snapshot_consistency_across_clone_and_reset():
    mt = _port()
    acc = mt.Accuracy(num_classes=NUM_CLASSES, device="cpu")
    acc.update(_P, _T)
    dolly = acc.clone()
    assert_snapshot_matches_reports(dolly)
    assert dolly.obs_snapshot()["compile"]["compiles"] == 0
    dolly.update(_P, _T)
    assert_snapshot_matches_reports(dolly)
    acc.reset()
    assert_snapshot_matches_reports(acc)
    mc = mt.MetricCollection(members())
    mc.update(_P, _T)
    cloned = mc.clone()
    cloned.update(_P, _T)
    cloned.reset()
    cloned.update(_P, _T)
    for key, m in cloned.items():
        member = cloned.obs_snapshot()["members"][key]
        assert member["compile"] == m.compile_stats()
        assert member["health"] == m.health_report()


def test_snapshot_consistency_across_checkpoint_restore(tmp_path):
    mt = _port()
    from metrics_tpu_torch.utils.checkpoint import load_metric_state, save_metric_state

    src = mt.Accuracy(num_classes=NUM_CLASSES, on_bad_input="skip", device="cpu")
    bad = _P_NP.copy()
    bad[0, 0] = np.nan
    src.update(torch.from_numpy(bad), _T)  # quarantined
    src.update(_P, _T)
    path = str(tmp_path / "acc.ckpt")
    save_metric_state(path, src)
    dst = load_metric_state(path, mt.Accuracy(num_classes=NUM_CLASSES, on_bad_input="skip", device="cpu"))
    assert_snapshot_matches_reports(dst)
    assert dst.obs_snapshot()["health"]["updates_quarantined"] == 1
    dst.update(_P, _T)
    assert_snapshot_matches_reports(dst)


@pytest.mark.parametrize("copier", ["pickle", "clone", "deepcopy"])
def test_pickle_preserves_sync_and_health_counters_but_not_compile(copier):
    mt = _port()
    acc = mt.Accuracy(num_classes=NUM_CLASSES, device="cpu")
    acc.update(_P, _T)
    stats = acc.compile_stats()
    assert stats["compiles"] + stats["cache_hits"] > 0
    acc._sync_stats["degraded_local"] = 3
    acc._sync_stats["retries"] = 5
    acc._health_stats["batches_screened"] = 7
    restored = {
        "pickle": lambda m: pickle.loads(pickle.dumps(m)),
        "clone": lambda m: m.clone(),
        "deepcopy": copy.deepcopy,
    }[copier](acc)
    assert restored.sync_report()["degraded_local"] == 3
    assert restored.sync_report()["retries"] == 5
    assert restored.health_report()["batches_screened"] == 7
    assert restored.compile_stats()["compiles"] == 0  # the program cache is the process's
    assert_snapshot_matches_reports(restored)
    restored._sync_stats["syncs"] += 1
    assert acc.sync_report()["syncs"] == 0  # the copy's counters are its own
    restored.update(_P, _T)
    acc.update(_P, _T)
    np.testing.assert_allclose(restored.compute().numpy(), acc.compute().numpy())


def test_wrapper_children_forward_every_surface():
    mt = _port()
    from metrics_tpu_torch.wrappers import ClasswiseWrapper, MinMaxMetric, MultioutputWrapper

    wrappers = {
        "minmax": (MinMaxMetric(mt.Accuracy(num_classes=NUM_CLASSES, device="cpu")), ["base"]),
        "classwise": (ClasswiseWrapper(mt.Accuracy(num_classes=NUM_CLASSES, average=None, device="cpu")), ["base"]),
        "multioutput": (MultioutputWrapper(mt.MeanSquaredError(device="cpu"), num_outputs=2), ["output_0", "output_1"]),
    }
    preds2 = torch.from_numpy(_rng.rand(8, 2).astype(np.float32))
    target2 = torch.from_numpy(_rng.rand(8, 2).astype(np.float32))
    for name, (wrapper, child_keys) in wrappers.items():
        if name == "multioutput":
            wrapper.update(preds2, target2)
        else:
            wrapper.update(_P, _T)
        for surface in ("compile_stats", "sync_report", "health_report"):
            report = getattr(wrapper, surface)()
            assert set(report["children"]) == set(child_keys), (name, surface)
            for key in child_keys:
                assert report["children"][key] == getattr(wrapper._children()[key], surface)(), (name, surface)
        snap = wrapper.obs_snapshot()
        assert "children" not in snap
        for section, surface in (("compile", "compile_stats"), ("sync", "sync_report"), ("health", "health_report")):
            assert set(snap[section]["children"]) == set(child_keys)
            for key in child_keys:
                assert snap[section]["children"][key] == getattr(wrapper._children()[key], surface)()


def test_bootstrapper_forwards_replicate_telemetry():
    mt = _port()
    from metrics_tpu_torch.wrappers import BootStrapper

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        bs = BootStrapper(mt.MeanSquaredError(device="cpu"), num_bootstraps=3)
        bs.update(torch.from_numpy(_rng.rand(8).astype(np.float32)), torch.from_numpy(_rng.rand(8).astype(np.float32)))
    snap = bs.obs_snapshot()
    for section in ("compile", "sync", "health"):
        assert {"template"} | {f"bootstrap_{i}" for i in range(3)} <= set(snap[section]["children"])


def test_tracker_snapshots_every_step():
    mt = _port()
    from metrics_tpu_torch.wrappers import MetricTracker

    tracker = MetricTracker(mt.Accuracy(num_classes=NUM_CLASSES, device="cpu"))
    for _ in range(2):
        tracker.increment()
        tracker.update(_P, _T)
    snap = tracker.obs_snapshot()
    assert mt.obs.snapshot(tracker) == snap
    assert snap["class"] == "MetricTracker" and snap["n_steps"] == 2
    assert set(snap["steps"]) == {"step_0", "step_1"}
    for i, report in enumerate(tracker.compile_stats()["steps"].values()):
        assert report == snap["steps"][f"step_{i}"]["compile"]
    for i, report in enumerate(tracker.sync_report()["steps"].values()):
        assert report == snap["steps"][f"step_{i}"]["sync"]
    assert set(tracker.health_report()["steps"]) == {"step_0", "step_1"}


def test_collection_snapshot_computes_each_member_report_once(monkeypatch):
    mt = _port()
    from metrics_tpu_torch.resilience import health as health_mod

    calls = []
    orig = health_mod.metric_report
    monkeypatch.setattr(health_mod, "metric_report", lambda m: (calls.append(type(m).__name__), orig(m))[1])
    mc = mt.MetricCollection(members())
    mc.update(_P, _T)
    calls.clear()
    mc.obs_snapshot()
    assert sorted(calls) == ["Accuracy", "ConfusionMatrix", "F1Score"]


def test_enabling_bus_changes_no_compiled_program():
    mt = _port()

    def run(bus_on):
        mt.engine.clear_cache()
        if bus_on:
            mt.obs.enable()
            mt.obs.enable_tracing()
        try:
            acc = mt.Accuracy(num_classes=NUM_CLASSES, jit_bucket="pow2", device="cpu")
            for n in (3, 3, 7, 16):
                acc.update(_P[:n], _T[:n])
            mc = mt.MetricCollection(members())
            mc.update(_P, _T)
            mc(_P, _T)
            mc.compute()
            summary = mt.engine.cache_summary()
            return {k: summary[k] for k in ("compiles", "retraces", "cache_hits", "calls", "bucketed_calls")}, (
                acc.compute(),
                mc.compute(),
            )
        finally:
            mt.obs.disable()
            mt.obs.disable_tracing()

    (off, off_vals), (on, on_vals) = run(False), run(True)
    assert off == on
    assert torch.equal(off_vals[0], on_vals[0])
    for key in off_vals[1]:
        assert torch.equal(off_vals[1][key], on_vals[1][key])


@pytest.mark.parametrize("policy", ["local", "raise"])
def test_degraded_sync_streams_events_and_keeps_reports_consistent(policy):
    """A failing gather (here a ``dist_sync_fn`` that raises) under each
    ``on_sync_error``: ``local`` keeps the local state, counts
    ``degraded_local`` and emits ``sync_degrade`` with outcome ``local``;
    ``raise`` raises ``SyncError`` with outcome ``failed``."""
    mt = _port()

    def broken(tensor, group=None):
        raise RuntimeError("peer lost")

    m = mt.SumMetric(dist_sync_fn=broken, on_sync_error=policy, device="cpu")
    m._distributed_available_fn = lambda: True
    m.update(torch.tensor(4.0))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with mt.obs.capture() as events:
            if policy == "local":
                assert float(m.compute()) == 4.0
            else:
                with pytest.raises(mt.SyncError):
                    m.compute()
    report = m.sync_report()
    assert report["syncs"] == 1 and report["attempts"] == 0  # a dist_sync_fn is the user's own gather
    assert report["degraded_local"] == (1 if policy == "local" else 0)
    assert report["last_sync_outcome"] == ("local" if policy == "local" else "failed")
    (degrade,) = [e for e in events if e.kind == "sync_degrade"]
    assert degrade.source == "SumMetric" and degrade.data["policy"] == policy
    assert degrade.data["outcome"] == ("local" if policy == "local" else "failed")
    assert "peer lost" in degrade.data["error"]
    assert [e.kind for e in events if e.kind in ("sync", "compute")] == ["sync", "compute"]
    assert_snapshot_matches_reports(m)


def test_jsonl_roundtrip_and_prometheus_render():
    mt = _port()
    mc = mt.MetricCollection(members())
    with mt.obs.capture() as events:
        mc.update(_P, _T)
        mc.compute()
    assert events
    buf = io.StringIO()
    written = mt.obs.to_jsonl(buf, events)
    assert written == len(events)
    buf.seek(0)
    assert mt.obs.validate_jsonl(buf) == written
    text = mt.obs.prometheus_text(mc)
    assert "metrics_tpu_engine_compiles" in text
    assert 'metrics_tpu_obs_events_total{kind="' in text
    assert 'member="acc"' in text
    assert "metrics_tpu_engine_async_fetches" in text
    jax_text = _jax().obs.prometheus_text()
    for family in (
        "metrics_tpu_wire_bytes_raw",
        "metrics_tpu_wire_payloads_total",
        "metrics_tpu_wire_max_dequant_error",
        "metrics_tpu_integrity_attest_failures",
        "metrics_tpu_compat_schema_decodes",
        "metrics_tpu_compat_wire_negotiations",
    ):
        assert f"# TYPE {family} " in text and f"# TYPE {family} " in jax_text, family
    process = mt.obs.snapshot()
    assert process["engine"] == mt.engine.cache_summary()
    assert process["fetch"] == mt.engine.fetch_stats()
    from metrics_tpu_torch.encoders import encoder_stats

    assert process["encoders"] == encoder_stats()
    assert process["kernels"]["by_op"] == mt.kernel_stats()
    assert set(process["kernels"]) == {"registered", "launches", "plain_calls", "by_op"}
    assert "confusion_counts" in process["kernels"]["registered"] and "policy" not in process["kernels"]
    # the resilient sync's sections are ported, under the JAX package's keys
    mj = _jax()
    jax_process = mj.obs.snapshot()
    # the fleet's and the guard's: fleet_stats() and guard_stats(), the JAX keys
    assert process["fleet"] == mt.fleet.fleet_stats() and process["guard"] == mt.fleet.guard_stats()
    for name in ("fleet", "guard"):
        assert set(process[name]) == set(jax_process[name]), name
    assert set(process["guard"]["overload"]) == set(jax_process["guard"]["overload"])
    # the warmup manifests' section: warmup_report(), the JAX keys
    assert process["warmup"] == mt.engine.warmup_report()
    assert set(process["warmup"]) == set(jax_process["warmup"])
    # the serving plane's: serving_summary() per bank, durability_stats()
    assert process["serving"] == mt.serving.serving_summary()
    assert process["durability"] == mt.serving.durability_stats()
    assert set(process["durability"]) == set(jax_process["durability"])
    port_bank = mt.serving.MetricBank(mt.Accuracy(num_classes=3, device="cpu"), capacity=2, name="obs_keys")
    jax_bank = mj.serving.MetricBank(mj.Accuracy(num_classes=3), capacity=2, name="obs_keys")
    assert set(mt.obs.snapshot()["serving"]["obs_keys"]) == set(mj.obs.snapshot()["serving"]["obs_keys"])
    bank_families = [f"metrics_tpu_bank_{k}" for k in ("capacity", "occupancy", "spilled", "admits", "launches")]
    for family in bank_families + ["metrics_tpu_durable_spill_writes", "metrics_tpu_durable_recovers"]:
        assert f"# TYPE {family} " in mt.obs.prometheus_text() and f"# TYPE {family} " in mj.obs.prometheus_text(), family
    del port_bank, jax_bank
    for name in ("wire", "integrity", "compat"):
        assert set(process[name]) == set(jax_process[name]), name
    assert process["wire"] == mt.parallel.wire_stats()
    assert set(process["wire"]["codec_counts"]) == set(jax_process["wire"]["codec_counts"])
    assert process["integrity"] == mt.resilience.integrity_stats()
    assert set(process["compat"]["wire_negotiation"]) == set(jax_process["compat"]["wire_negotiation"])
    assert process["compat"]["families"]["wire"]["versions"] == jax_process["compat"]["families"]["wire"]["versions"]
    assert set(process["compat"]["families"]["wire"]) == set(jax_process["compat"]["families"]["wire"])
    # the sharded state plane is ported: its section is shard_stats()
    assert process["sharding"] == mt.sharding.shard_stats()
    assert set(process["sharding"]) == {"sharded_drives", "reshard_events", "mesh_changes", "specs", "resident"}
    assert process["bus"]["by_kind"]["compile"] >= 1


def test_pod_bank_shard_families_match_jax(monkeypatch):
    """The ``metrics_tpu_bank_shard_*`` families of a tenant-sharded bank:
    the port renders a pod bank's summary (here the JAX pod bank's, on a
    ``(4,)`` mesh of its virtual devices) into the JAX package's lines, names,
    labels and values; a one-shard bank renders none of them."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    mj = _jax()
    mt = _port()
    from metrics_tpu_torch.obs import export as port_export

    mesh = Mesh(np.array(jax.devices()[:4]), ("host",))
    bank = mj.serving.MetricBank(mj.Accuracy(num_classes=3), capacity=2, mesh=mesh, tenant_axis="host", name="obs_pod")
    rng = np.random.RandomState(0)
    for i in range(6):
        bank.update(f"t{i}", jnp.asarray(rng.randint(0, 3, 8)), jnp.asarray(rng.randint(0, 3, 8)))

    def shard_lines(text):
        return sorted(l for l in text.splitlines() if "metrics_tpu_bank_shard" in l and "obs_pod" in l)

    want = shard_lines(mj.obs.prometheus_text())
    assert len([l for l in want if l.startswith("metrics_tpu_bank_shard_occupancy{")]) == 4
    monkeypatch.setattr(port_export, "_serving_summary", lambda: {"obs_pod": bank.summary()})
    text = mt.obs.prometheus_text()
    assert shard_lines(text) == want
    for family in ("shard_count", "shard_capacity", "shard_occupancy"):
        assert f"# TYPE metrics_tpu_bank_{family} gauge" in text
    one = mt.serving.MetricBank(mt.Accuracy(num_classes=3, device="cpu"), capacity=2, name="obs_one")
    monkeypatch.setattr(port_export, "_serving_summary", lambda: {"obs_one": one.summary()})
    assert "metrics_tpu_bank_shard" not in mt.obs.prometheus_text()


def test_validate_jsonl_rejects_bad_lines():
    obs = _port().obs
    good = '{"v": 1, "seq": 1, "kind": "compile", "t": 0.0, "source": "m", "data": {}}'
    assert obs.validate_jsonl(io.StringIO(good)) == 1
    for bad, match in [
        ("not json", "not valid JSON"),
        ('{"v": 1}', "missing fields"),
        ('{"v": 99, "seq": 1, "kind": "compile", "t": 0.0, "source": "m", "data": {}}', "schema version"),
        ('{"v": 1, "seq": 1, "kind": "nope", "t": 0.0, "source": "m", "data": {}}', "unknown kind"),
        ('{"v": 1, "seq": "x", "kind": "compile", "t": 0.0, "source": "m", "data": {}}', "non-numeric"),
        ('{"v": 1, "seq": 1, "kind": "compile", "t": 0.0, "source": "m", "data": []}', "non-object data"),
    ]:
        with pytest.raises(ValueError, match=match):
            obs.validate_jsonl(io.StringIO(bad))


# ---------------------------------------------------------------------------
# the port's emit sites
# ---------------------------------------------------------------------------
def test_disabled_bus_builds_no_event_anywhere(monkeypatch):
    """With the bus and tracing off, nothing on the lifecycle, the engine,
    bucketing, the registry, health, the fetch or the drive builds an event
    or a span: ``emit`` and ``span`` raise if anything reaches them."""
    mt = _port()
    from metrics_tpu_torch.obs import bus, trace

    def boom(*_a, **_k):
        raise AssertionError("an event or span was built with observability off")

    monkeypatch.setattr(bus, "emit", boom)
    monkeypatch.setattr(trace, "span", boom)
    monkeypatch.setattr(mt.obs.explain, "signature", boom)
    mc = mt.MetricCollection({k: m for k, m in members().items()})
    mc(_P, _T)
    mc.update(_P[:7], _T[:7])
    bucketed = mt.Accuracy(num_classes=NUM_CLASSES, jit_bucket="pow2", device="cpu")
    bucketed.update(_P[:7], _T[:7])
    raising = mt.MeanMetric(on_bad_input="raise", device="cpu")
    with pytest.raises(mt.NumericalHealthError):
        raising.update(torch.tensor([1.0, float("nan")]))
    mt.engine.drive(mc, (_P[:8].view(2, 4, NUM_CLASSES), _T[:8].view(2, 4)))
    mc.compute_async().result()
    mc.compute()


def test_quarantine_events_name_their_path():
    mt = _port()
    mt.obs.enable()
    compiled = mt.MeanMetric(on_bad_input="raise", device="cpu")
    compiled.update(torch.tensor([1.0, 2.0]))
    with pytest.raises(mt.NumericalHealthError):
        compiled.update(torch.tensor([1.0, float("nan"), float("inf")]))
    eager = mt.MeanMetric(on_bad_input="skip", jit_update=False, device="cpu")
    eager.update(torch.tensor([float("nan"), 1.0]))
    events = mt.obs.events("quarantine")
    assert [(e.source, e.data["path"], e.data["policy"]) for e in events] == [
        ("MeanMetric", "compiled", "raise"),
        ("MeanMetric", "eager", "skip"),
    ]
    assert (events[0].data["nan_count"], events[0].data["inf_count"], events[0].data["update_index"]) == (1, 1, 2)
    assert (events[1].data["nan_count"], events[1].data["update_index"]) == (1, 1)


def test_encode_stream_emits_one_event_per_chunk():
    """Three chunks with a ragged tail: three ``encode`` events whose rows
    sum to the real rows, the tail padded to its pow2 bucket, and a
    ``pre_encode`` quarantine for the contaminated chunk under ``skip``."""
    mt = _port()
    from metrics_tpu_torch.encoders import ShardedEncoder, encode_stream

    def apply(params, x):
        return x @ params["w"]

    def consumer(carry, feats, valid):
        return {"s": carry["s"] + (feats * valid[:, None]).sum(0), "n": carry["n"] + valid.sum()}

    class Screen:
        on_bad_input = "skip"
        health_screen = "nonfinite"

        def __init__(self):
            self._health_stats = {"batches_screened": 0}

    rng = np.random.RandomState(3)
    enc = ShardedEncoder(apply, {"w": torch.from_numpy(rng.rand(6, 4).astype(np.float32))}, name="mlp")
    chunks = [rng.rand(8, 6).astype(np.float32), rng.rand(8, 6).astype(np.float32), rng.rand(5, 6).astype(np.float32)]
    bad = rng.rand(8, 6).astype(np.float32)
    bad[1, 1] = np.nan
    mt.obs.enable()
    carry, result = encode_stream(enc, chunks + [bad], consumer, {"s": torch.zeros(4), "n": torch.tensor(0.0)}, screen=Screen())
    events = mt.obs.events("encode")
    assert len(events) == 3 == result.chunks
    assert sum(e.data["rows"] for e in events) == 21 == result.rows == int(carry["n"])
    assert [e.data["bucket"] for e in events] == [8, 8, 8]
    assert all(e.data["encoder"] == "mlp" and e.data["fused"] is True and e.source == "Screen" for e in events)
    (quarantine,) = mt.obs.events("quarantine")
    assert quarantine.data["path"] == "pre_encode" and quarantine.data["nan_count"] == 1


def test_fetch_drive_and_kernel_events():
    mt = _port()
    mc = mt.MetricCollection(members())
    mt.reset_kernel_stats()
    mt.obs.enable()
    result = mt.engine.drive(mc, (_P[:8].view(2, 4, NUM_CLASSES), _T[:8].view(2, 4)))
    assert result.steps == 2
    (drive,) = mt.obs.events("drive")
    assert drive.source == "MetricCollection" and drive.data["fenced"] is False
    handle = mc.compute_async()
    handle.result()
    handle.result()  # resolved once
    (fetch,) = mt.obs.events("fetch")
    assert fetch.source == "MetricCollection" and fetch.data == {"leaves": 3, "coalesced": True}
    kernels = mt.obs.events("kernel")
    assert kernels and all(e.data["path"] == "plain" and e.data["reason"] == "cpu_input" for e in kernels)
    # on the CPU every dispatch is a plain call that Python runs: one event each
    for op, rec in mt.kernel_stats().items():
        assert len([e for e in kernels if e.data["op"] == op]) == rec["plain_calls"] > 0


# ---------------------------------------------------------------------------
# parity with metrics_tpu on the same inputs
# ---------------------------------------------------------------------------
def test_roots_export_the_jax_observability_surface():
    mt, mj = _port(), _jax()
    assert set(mj.obs.__all__) <= set(mt.obs.__all__)
    for name in mj.obs.__all__:
        assert hasattr(mt.obs, name), name
    assert mt.obs.EVENT_KINDS == mj.obs.EVENT_KINDS
    assert mt.obs.explain.COMPONENTS == mj.obs.explain.COMPONENTS
    assert mt.obs.JSONL_SCHEMA_VERSION == mj.obs.JSONL_SCHEMA_VERSION
    assert set(mt.obs.process_snapshot()) == set(mj.obs.process_snapshot())


def _stream_kinds(pkg, sizes, **kw):
    """The engine and lifecycle event kinds of one seeded Accuracy stream
    (updates, then a compute), with each retrace's explain components."""
    is_port = pkg is _port()
    conv = torch.from_numpy if is_port else _jax_array
    m = pkg.Accuracy(num_classes=NUM_CLASSES, **kw, **({"device": "cpu"} if is_port else {}))
    rng = np.random.RandomState(0)
    with pkg.obs.capture() as events:
        for n in sizes:
            m.update(conv(rng.rand(n, NUM_CLASSES).astype(np.float32)), conv(rng.randint(0, NUM_CLASSES, size=n).astype(np.int64)))
        m.compute()
    return [(e.kind, e.data["explain"]["changed"] if e.kind == "retrace" else None) for e in events if e.kind in ENGINE_KINDS]


def _jax_array(x):
    import jax.numpy as jnp

    return jnp.asarray(x)


@pytest.mark.parametrize(
    "kw,sizes", [({}, (4, 4, 4, 8, 8)), ({"jit_bucket": "pow2"}, (3, 3, 5, 9, 17, 33))], ids=["exact", "pow2"]
)
def test_event_kinds_match_jax(kw, sizes):
    port = _stream_kinds(_port(), sizes, **kw)
    jax_seq = _stream_kinds(_jax(), sizes, **kw)
    # the JAX package may retrace once on a weakly typed fresh state, where
    # the port hits its cache: at most one such difference
    weak = [i for i, (a, b) in enumerate(zip(port, jax_seq)) if a != b]
    assert len(port) == len(jax_seq)
    assert len(weak) <= 1
    for i in weak:
        assert port[i] == ("cache_hit", None) and jax_seq[i] == ("retrace", ["dtype"])
    if not kw:
        assert port == jax_seq


def _retrace_components(pkg, change):
    is_port = pkg is _port()
    conv = torch.from_numpy if is_port else _jax_array
    kw = {"jit_bucket": "pow2"} if change == "bucket" else {}
    m = pkg.Accuracy(num_classes=NUM_CLASSES, **kw, **({"device": "cpu"} if is_port else {}))
    rng = np.random.RandomState(5)
    p, t = rng.rand(4, NUM_CLASSES).astype(np.float32), rng.randint(0, NUM_CLASSES, size=4).astype(np.int64)
    pkg.obs.enable()
    for _ in range(2):
        m.update(conv(p), conv(t))
    pkg.obs.bus.clear()
    if change == "bucket":
        p2, t2 = rng.rand(7, NUM_CLASSES).astype(np.float32), rng.randint(0, NUM_CLASSES, size=7).astype(np.int64)
    elif change == "shape":
        p2, t2 = rng.rand(6, NUM_CLASSES).astype(np.float32), rng.randint(0, NUM_CLASSES, size=6).astype(np.int64)
    else:
        p2, t2 = p.astype(np.float64), t
    m.update(conv(p2), conv(t2))
    retraces = pkg.obs.events("retrace")
    pkg.obs.disable()
    assert len(retraces) == 1, retraces
    return retraces[0].data["explain"]["changed"]


@pytest.mark.parametrize("change", ["bucket", "shape", "dtype"])
def test_retrace_components_match_jax(change):
    port = _retrace_components(_port(), change)
    assert port == _retrace_components(_jax(), change)
    assert port == {"bucket": ["avals", "bucket"], "shape": ["avals"], "dtype": ["dtype"]}[change]


def _key_set(tree, prefix=""):
    out = set()
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.add(prefix + str(k))
            out |= _key_set(v, prefix + str(k) + ".")
    return out


def _snapshot_subjects(pkg):
    is_port = pkg is _port()
    conv = torch.from_numpy if is_port else _jax_array
    kw = {"device": "cpu"} if is_port else {}
    p, t = conv(_P_NP), conv(_T_NP)
    metric = pkg.Accuracy(num_classes=NUM_CLASSES, **kw)
    metric.update(p, t)
    mc = pkg.MetricCollection(members(pkg))
    mc.update(p, t)
    tracker = pkg.wrappers.MetricTracker(pkg.Accuracy(num_classes=NUM_CLASSES, **kw))
    for _ in range(2):
        tracker.increment()
        tracker.update(p, t)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        boot = pkg.wrappers.BootStrapper(pkg.MeanSquaredError(**kw), num_bootstraps=3)
        boot.update(conv(_P_NP[:, 0]), conv(_P_NP[:, 1]))
    return {"metric": metric, "collection": mc, "tracker": tracker, "bootstrapper": boot}


@pytest.mark.parametrize("subject", ["metric", "collection", "tracker", "bootstrapper"])
def test_snapshot_key_sets_match_jax(subject):
    port = _snapshot_subjects(_port())[subject]
    jax_obj = _snapshot_subjects(_jax())[subject]
    assert _key_set(port.obs_snapshot()) == _key_set(jax_obj.obs_snapshot())
    assert _key_set(port.sync_report()) == _key_set(jax_obj.sync_report())
    assert _port().obs.snapshot(port) == port.obs_snapshot()


def _collection_run(pkg, events_out):
    is_port = pkg is _port()
    conv = torch.from_numpy if is_port else _jax_array
    mc = pkg.MetricCollection(members(pkg))
    with pkg.obs.capture() as events:
        mc(conv(_P_NP[:8]), conv(_T_NP[:8]))
        mc.update(conv(_P_NP), conv(_T_NP))
        mc.compute()
    events_out.extend(events)
    return mc


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_jsonl_validates_under_the_other_package(writer):
    mt, mj = _port(), _jax()
    events = []
    _collection_run(mt if writer == "port" else mj, events)
    buf = io.StringIO()
    written = (mt if writer == "port" else mj).obs.to_jsonl(buf, events)
    assert written == len(events) > 0
    buf.seek(0)
    assert (mj if writer == "port" else mt).obs.validate_jsonl(buf) == written


def _families(text):
    fams = {}
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        name = line.split("{")[0].split(" ")[0]
        labels = line.split("{")[1].split("}")[0] if "{" in line else ""
        members_of = {part.split("=")[1].strip('"') for part in labels.split(",") if part.startswith("member=")}
        fams.setdefault(name, set()).update(members_of)
    return fams


def test_prometheus_families_match_jax():
    mt, mj = _port(), _jax()
    port_mc = _collection_run(mt, [])
    jax_mc = _collection_run(mj, [])
    port_fams = _families(mt.obs.prometheus_text(port_mc))
    jax_fams = _families(mj.obs.prometheus_text(jax_mc))
    missing = sorted(set(port_fams) - set(jax_fams))
    assert not missing, missing
    for name, member_labels in port_fams.items():
        assert member_labels == jax_fams[name], name
    assert port_fams["metrics_tpu_metric_compile_compiles"] == {"acc", "confmat", "f1"}


# ---------------------------------------------------------------------------
# two gloo ranks: sync_report against the gathers each rank made
# ---------------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, port: int, out_path: str) -> None:
    import datetime

    import torch.distributed as dist

    import metrics_tpu_torch as mt

    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank, timeout=datetime.timedelta(seconds=60)
    )
    try:
        mc = mt.MetricCollection(members(mt))
        mine = slice(rank * 8, rank * 8 + 8 - 3 * rank)  # ranks hold 8 and 5 rows
        mc.update(_P[mine], _T[mine])
        mt.obs.enable()
        values = mc.compute()
        buffer = mt.CatMetric(device="cpu")  # a cat state: a shape exchange, then a padded gather
        buffer.update(_P[mine, 0])
        gathered = buffer.compute()
        events = mt.obs.events()
        torch.save(
            {
                "acc": values["acc"],
                "buffer": gathered,
                "reports": {k: m.sync_report() for k, m in mc.items()},
                "buffer_report": buffer.sync_report(),
                "attempts": [(e.source, e.data) for e in events if e.kind == "sync_attempt"],
                "syncs": len([e for e in events if e.kind == "sync"]),
            },
            out_path,
        )
    finally:
        dist.destroy_process_group()


def test_sync_report_counts_the_gathers_of_two_gloo_ranks(tmp_path):
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = []
    for rank in range(2):
        log = open(tmp_path / f"rank{rank}.log", "w+")
        cmd = [sys.executable, os.path.abspath(__file__), str(rank), "2", str(port), str(tmp_path / f"rank{rank}.pt")]
        procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO), log))
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    failures = []
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
    out = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    assert torch.equal(out[0]["acc"], out[1]["acc"])
    assert torch.equal(out[0]["buffer"], torch.cat([_P[0:8, 0], _P[8:13, 0]]))
    for rank, res in enumerate(out):
        other = out[1 - rank]
        for key, report in res["reports"].items():
            n_states = len(members(_port())[key]._defaults)
            # one sync per compute(), one fixed-shape gather per sum state
            assert report["syncs"] == 1 and report["attempts"] == n_states, (key, report)
            assert report["last_sync_outcome"] == "complete"
            assert report["bytes_sent"] > 0
            assert report["bytes_received"] == other["reports"][key]["bytes_sent"]
            assert report["degraded_local"] == 0 and report["missing_ranks"] == []
        buf = res["buffer_report"]
        assert buf["syncs"] == 1 and buf["attempts"] == 1 and buf["last_sync_outcome"] == "complete"
        assert buf["bytes_received"] == other["buffer_report"]["bytes_sent"]
        # the padded gather moves 8 float32 rows on each rank, after the shape records
        shape_bytes = 11 * 8
        assert buf["bytes_sent"] == shape_bytes + 8 * 4
        n_gathers = sum(r["attempts"] for r in res["reports"].values()) + 1
        assert len(res["attempts"]) == n_gathers
        assert all(src == "torch.distributed" and d == {"world": 2, "rank": rank} for src, d in res["attempts"])
        assert res["syncs"] == len(res["reports"]) + 1  # a sync span per member, and the buffer's


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

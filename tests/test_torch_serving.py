"""The port's serving plane (``metrics_tpu_torch.serving``) against
``metrics_tpu.serving`` on the same numpy inputs.

Every case runs one scenario twice, once on each package (a ``Side`` hands
it the package's metrics, banks and array type; the port builds its metrics
with ``device="cpu"``), and holds the two observation trees against each
other: per-tenant states and ``compute()`` (integer states bit for bit,
float states within 1e-6 relative, the ``docs/kernels.md`` tolerance of
float sums), ``stats`` and the LRU order, router waves and flush counts,
dedup drops and the ``serving_summary()`` keys. The scenarios are those of
``tests/serving/test_bank.py``, ``test_router.py`` and the single-device
part of ``test_pod_bank.py`` (the bank drive and the collection banks), one
case each, with those tests' own checks run on both sides.

Besides: more of the bank's surface on both packages (a collection bank's
export and import with its payload bytes, its pow2-bucketed router waves
and its screening policies; the checkpoint cadence and lag); a wave that
fails in the middle of its requests leaves the bank unchanged, and so does
a program's warm-up ahead of its capture; ``sync_bank_states`` on a
two-rank gloo world (a ``("dp",)``
``DeviceMesh``) against the JAX package's ``comm.sync_bank_states`` under
``shard_map``, hierarchical against flat; ``mesh=``, ``warmup()`` and
``OrbaxStore`` raise with their messages; and the package root exports
``serving`` with the JAX ``__all__``.
"""
import importlib
import os
import socket
import subprocess
import sys
import time
from datetime import timedelta

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_CLASSES = 5
FLOAT_RTOL = 1e-6
WORKER_TIMEOUT_S = 120


class Side:
    """One package as a scenario sees it."""

    def __init__(self, name: str) -> None:
        self.name = name
        if name == "jax":
            import jax.numpy as jnp

            import metrics_tpu as pkg

            self.kw = {}
            self._arr = jnp.asarray
        else:
            import metrics_tpu_torch as pkg

            self.kw = {"device": "cpu"}
            self._arr = torch.as_tensor
        self.pkg = pkg
        self.exc = importlib.import_module(f"{pkg.__name__}.utils.exceptions")
        self.serving = pkg.serving
        self.store = pkg.serving.store
        self.integrity = pkg.resilience.integrity
        self.obs = pkg.obs
        self.engine = pkg.engine

    def m(self, cls: str, **kw):
        return getattr(self.pkg, cls)(**kw, **self.kw)

    def coll(self, members: dict):
        return self.pkg.MetricCollection(members)

    def arr(self, x):
        return self._arr(np.asarray(x))

    def bank(self, template, capacity, **kw):
        return self.serving.MetricBank(template, capacity, **kw)

    def router(self, bank, **kw):
        return self.serving.RequestRouter(bank, **kw)


SIDES = ("jax", "torch")


def host(x):
    """Numpy of a JAX array, a tensor, a scalar or a nested dict."""
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def same(j, t, path="obs"):
    """Hold the port's observation ``t`` against the JAX package's ``j``."""
    if isinstance(j, dict):
        assert isinstance(t, dict) and set(j) == set(t), f"{path}: keys {sorted(map(str, j))} vs {sorted(map(str, t))}"
        for k in j:
            same(j[k], t[k], f"{path}[{k!r}]")
        return
    if isinstance(j, (list, tuple)):
        assert isinstance(t, (list, tuple)) and len(j) == len(t), f"{path}: {j!r} vs {t!r}"
        for i, (a, b) in enumerate(zip(j, t)):
            same(a, b, f"{path}[{i}]")
        return
    if isinstance(j, (bytes, str, bool, type(None))) or isinstance(t, (bytes, str, bool, type(None))):
        assert j == t, f"{path}: {j!r} vs {t!r}"
        return
    a, b = host(j), host(t)
    assert a.shape == b.shape, f"{path}: shape {a.shape} vs {b.shape}"
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64), rtol=FLOAT_RTOL, atol=0, err_msg=path)
    else:
        assert a.dtype.kind == b.dtype.kind, f"{path}: dtype {a.dtype} vs {b.dtype}"
        np.testing.assert_array_equal(b, a, err_msg=path)


def run_both(scenario, *args):
    """The scenario on each package, from a clean program cache; the two
    observations must agree."""
    out = {}
    for name in SIDES:
        side = Side(name)
        side.engine.clear_cache()
        out[name] = scenario(side, *args)
        side.engine.clear_cache()
    same(out["jax"], out["torch"])
    return out


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------
def cls_stream(S, seed, n=6, batch=16, nan_rows=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        preds = rng.rand(batch, NUM_CLASSES).astype(np.float32)
        target = rng.randint(0, NUM_CLASSES, size=batch).astype(np.int32)
        if nan_rows and i % 2 == 1:
            preds[:nan_rows, 0] = np.nan
        out.append((S.arr(preds), S.arr(target)))
    return out


def req(S, seed, batch=8, classes=NUM_CLASSES):
    rng = np.random.RandomState(seed)
    return (
        S.arr(rng.rand(batch, classes).astype(np.float32)),
        S.arr(rng.randint(0, classes, size=batch).astype(np.int32)),
    )


def int_req(S, seed, batch=8, classes=8):
    rng = np.random.RandomState(seed)
    return (
        S.arr(rng.randint(0, classes, size=batch).astype(np.int32)),
        S.arr(rng.randint(0, classes, size=batch).astype(np.int32)),
    )


def ones(S, n, value=1.0):
    return S.arr(np.full(n, value, np.float32))


def states_equal_solo(bank, tenant, solo):
    """The JAX tests' check on one side: the tenant equals its solo twin."""
    state = bank.tenant_state(tenant)
    for name, value in solo._snapshot_state().items():
        np.testing.assert_array_equal(host(value), host(state[name]), err_msg=name)
    assert bank.update_count(tenant) == solo._update_count


def tenant_obs(bank, tenants):
    return {str(t): {"state": host(bank.tenant_state(t)), "count": bank.update_count(t), "value": host(bank.compute(t))} for t in tenants}


def bank_obs(bank, tenants=None):
    tenants = list(tenants) if tenants is not None else bank.tenants + bank.spilled_tenants
    return {
        "stats": dict(bank.stats),
        "tenants": [str(t) for t in bank.tenants],
        "spilled": [str(t) for t in bank.spilled_tenants],
        "lru": [str(t) for t in sorted(bank._lru, key=bank._lru.get)],
        "per_tenant": tenant_obs(bank, tenants),
    }


# ---------------------------------------------------------------------------
# tests/serving/test_bank.py
# ---------------------------------------------------------------------------
def _serve_interleaved(S, factory, stream_a, others):
    bank = S.bank(factory(), capacity=len(others) + 1)
    n = len(stream_a)
    for i in range(n):
        bank.apply_batch([("A", stream_a[i])] + [(t, s[i]) for t, s in others.items()])
        bank.update("churn", *stream_a[i])  # full bank: evicts an LRU member
        if i == n // 2:
            if "A" in bank.tenants:
                bank.evict("A")
            assert "A" in bank.spilled_tenants
            bank.admit("A")
    assert bank.stats["spills"] > 0 and bank.stats["readmits"] > 0
    return bank


CLS_FACTORIES = {
    "accuracy": lambda S: S.m("Accuracy", num_classes=NUM_CLASSES),
    "stat_scores": lambda S: S.m("StatScores", num_classes=NUM_CLASSES, reduce="macro"),
    "precision": lambda S: S.m("Precision", num_classes=NUM_CLASSES, average="macro"),
    "f1": lambda S: S.m("F1Score", num_classes=NUM_CLASSES, average="micro"),
    "confusion_matrix": lambda S: S.m("ConfusionMatrix", num_classes=NUM_CLASSES),
}


def sc_bit_identity_classification(S, kind):
    factory = lambda: CLS_FACTORIES[kind](S)  # noqa: E731
    stream_a = cls_stream(S, 1)
    others = {"B": cls_stream(S, 2), "C": cls_stream(S, 3)}
    solo = factory()
    for args in stream_a:
        solo.update(*args)
    bank = _serve_interleaved(S, factory, stream_a, others)
    states_equal_solo(bank, "A", solo)
    np.testing.assert_array_equal(host(solo.compute()), host(bank.compute("A")))
    return bank_obs(bank)


def _float_stream(seeds):
    return [np.random.RandomState(s).rand(16).astype(np.float32) for s in seeds]


def sc_bit_identity_aggregation(S, kind):
    cls = {"sum": "SumMetric", "mean": "MeanMetric"}[kind]
    factory = lambda: S.m(cls, nan_strategy="disable")  # noqa: E731
    stream = [(S.arr(v),) for v in _float_stream(range(4))]
    solo = factory()
    for args in stream:
        solo.update(*args)
    rng = np.random.RandomState(77)
    others = {"B": [(S.arr(rng.rand(16).astype(np.float32)),) for _ in stream]}
    bank = _serve_interleaved(S, factory, stream, others)
    states_equal_solo(bank, "A", solo)
    np.testing.assert_array_equal(host(solo.compute()), host(bank.compute("A")))
    return bank_obs(bank)


def sc_bit_identity_screening(S, policy):
    factory = lambda: S.m("Accuracy", num_classes=NUM_CLASSES, on_bad_input=policy)  # noqa: E731
    stream_a = cls_stream(S, 11, nan_rows=3)
    others = {"B": cls_stream(S, 12, nan_rows=2), "C": cls_stream(S, 13)}
    solo = factory()
    for args in stream_a:
        solo.update(*args)
    bank = _serve_interleaved(S, factory, stream_a, others)
    states_equal_solo(bank, "A", solo)
    summary = bank.summary()
    assert summary["updates_quarantined" if policy == "skip" else "rows_masked"] > 0
    keys = ("nan_count", "inf_count", "rows_masked", "updates_quarantined", "quarantine_rate")
    return {**bank_obs(bank), "health": {k: summary[k] for k in keys}}


def sc_pow2_bucketed(S):
    factory = lambda: S.m("SumMetric", nan_strategy="disable", jit_bucket="pow2")  # noqa: E731
    rng = np.random.RandomState(5)
    sizes = [5, 7, 8, 3, 6]
    stream_a = [(S.arr(rng.rand(n).astype(np.float32)),) for n in sizes]
    solo = factory()
    for args in stream_a:
        solo.update(*args)
    bank = S.bank(factory(), capacity=4)
    for i, args in enumerate(stream_a):
        bank.apply_batch([("A", args), ("B", (S.arr(rng.rand(sizes[i]).astype(np.float32)),))])
    assert bank.stats["bucketed_requests"] > 0
    states_equal_solo(bank, "A", solo)
    return bank_obs(bank)


def sc_mixed_shapes_rejected(S):
    bank = S.bank(S.m("SumMetric", nan_strategy="disable"), capacity=4)
    with pytest.raises(ValueError, match="did not opt into"):
        bank.apply_batch([("A", (ones(S, 4),)), ("B", (ones(S, 6),))])
    return dict(bank.stats)


def sc_launch_amortization(S):
    bank = S.bank(S.m("Accuracy", num_classes=NUM_CLASSES), capacity=32)
    streams = {f"t{i}": cls_stream(S, i, n=3) for i in range(16)}
    for step in range(3):
        bank.apply_batch([(t, s[step]) for t, s in streams.items()])
    assert bank.stats["launches"] == 3 and bank.stats["requests"] == 48
    kinds = S.engine.cache_summary()["by_kind"]["bank_update"]
    assert kinds["cache_hits"] >= 1
    return {**bank_obs(bank), "cache": {k: kinds[k] for k in ("entries", "calls", "compiles", "cache_hits")}}


def sc_dense_and_scatter(S):
    solo = S.m("Accuracy", num_classes=NUM_CLASSES)
    stream = cls_stream(S, 21, n=2)
    for args in stream:
        solo.update(*args)
    dense = S.bank(S.m("Accuracy", num_classes=NUM_CLASSES), capacity=4, dense_threshold=0.0)
    scatter = S.bank(S.m("Accuracy", num_classes=NUM_CLASSES), capacity=4, dense_threshold=2.0)
    for args in stream:
        dense.apply_batch([("A", args), ("B", args)])
        scatter.apply_batch([("A", args), ("B", args)])
    assert dense.stats["dense_launches"] == 2 and dense.stats["scatter_launches"] == 0
    assert scatter.stats["scatter_launches"] == 2 and scatter.stats["dense_launches"] == 0
    states_equal_solo(dense, "A", solo)
    states_equal_solo(scatter, "A", solo)
    return {"dense": bank_obs(dense), "scatter": bank_obs(scatter)}


def sc_spill_readmit(S):
    bank = S.bank(S.m("ConfusionMatrix", num_classes=NUM_CLASSES), capacity=1)
    solo = S.m("ConfusionMatrix", num_classes=NUM_CLASSES)
    filler = cls_stream(S, 99, n=4)
    for i, args in enumerate(cls_stream(S, 31, n=4)):
        solo.update(*args)
        bank.update("A", *args)
        bank.update("filler", *filler[i])  # evicts A (capacity 1)
        assert "A" in bank.spilled_tenants
    states_equal_solo(bank, "A", solo)
    np.testing.assert_array_equal(host(solo.compute()), host(bank.compute("A")))
    return bank_obs(bank)


def sc_lru_order(S):
    bank = S.bank(S.m("Accuracy", num_classes=NUM_CLASSES), capacity=2)
    s = cls_stream(S, 41, n=1)[0]
    for t in ("A", "B", "A", "C"):
        bank.update(t, *s)
    assert set(bank.tenants) == {"A", "C"} and bank.spilled_tenants == ["B"]
    return bank_obs(bank)


def sc_duplicate_tenant_rejected(S):
    bank = S.bank(S.m("Accuracy", num_classes=NUM_CLASSES), capacity=4)
    s = cls_stream(S, 51, n=1)[0]
    with pytest.raises(ValueError, match="multiple requests for one tenant"):
        bank.apply_batch([("A", s), ("A", s)])
    return dict(bank.stats)


def sc_over_capacity_rejected(S):
    bank = S.bank(S.m("Accuracy", num_classes=NUM_CLASSES), capacity=2)
    s = cls_stream(S, 52, n=1)[0]
    with pytest.raises(ValueError, match="exceeds bank capacity"):
        bank.apply_batch([(f"t{i}", s) for i in range(3)])
    return dict(bank.stats)


def sc_unbankable(S):
    MetricsUserError = S.exc.MetricsUserError
    cases = (
        (lambda: S.m("CatMetric"), "list states"),
        (lambda: S.m("Accuracy", num_classes=NUM_CLASSES, on_bad_input="raise"), "raise"),
        (lambda: S.m("MeanMetric", nan_strategy="warn"), "eager"),
    )
    messages = []
    for make, match in cases:
        with pytest.raises(MetricsUserError, match=match) as err:
            S.bank(make(), capacity=4)
        messages.append(str(err.value))
    return messages


def sc_compute_async(S):
    bank = S.bank(S.m("Accuracy", num_classes=NUM_CLASSES), capacity=8)
    for i, t in enumerate(("A", "B", "C")):
        for args in cls_stream(S, 60 + i, n=2):
            bank.update(t, *args)
    S.engine.reset_fetch_stats()
    handle = bank.compute_async(["A", "B", "C"])
    values = handle.result()
    handle.result()  # resolving twice does not fetch again
    assert S.engine.fetch_stats()["async_fetches"] == 1
    for t in ("A", "B", "C"):
        np.testing.assert_array_equal(host(values[t]), host(bank.compute(t)))
    return {"values": host(values), "fetch": S.engine.fetch_stats()}


def sc_materialize(S):
    bank = S.bank(S.m("Accuracy", num_classes=NUM_CLASSES), capacity=4)
    solo = S.m("Accuracy", num_classes=NUM_CLASSES)
    for args in cls_stream(S, 61, n=3):
        solo.update(*args)
        bank.update("A", *args)
    metric = bank.materialize("A")
    assert type(metric).__name__ == "Accuracy" and metric._update_count == 3
    value = host(metric.compute())
    np.testing.assert_array_equal(value, host(solo.compute()))
    metric.reset()  # the clone is independent of the bank
    states_equal_solo(bank, "A", solo)
    return {"value": value, **bank_obs(bank)}


def sc_state_spec_layout(S):
    MetricsUserError = S.exc.MetricsUserError
    m = S.m("Accuracy", num_classes=NUM_CLASSES)
    spec = m.state_spec()
    bank = S.bank(m, capacity=3)
    layout = {}
    for name, s in spec.items():
        leaf = bank._bank[name]
        assert tuple(leaf.shape) == (3,) + tuple(s.shape)
        layout[name] = (tuple(leaf.shape), str(s.dtype).replace("torch.", ""))
    clone = S.m("Accuracy", num_classes=NUM_CLASSES)
    clone.bind_state(m._snapshot_state(), update_count=0)
    with pytest.raises(MetricsUserError, match="does not match"):
        clone.bind_state({"nope": S.arr(np.zeros(()))})
    with pytest.raises(MetricsUserError, match="registered shape"):
        clone.bind_state({n: S.arr(np.zeros((7,) + tuple(s.shape), np.float32)) for n, s in spec.items()})
    return layout


def sc_events_and_summary(S):
    with S.obs.capture(kinds=("admit", "evict", "flush")) as events:
        bank = S.bank(S.m("Accuracy", num_classes=NUM_CLASSES), capacity=1, name="evbank")
        s = cls_stream(S, 71, n=1)[0]
        bank.update("x", *s)
        bank.update("y", *s)  # evicts x
    kinds = [e.kind for e in events]
    assert kinds.count("admit") == 2 and kinds.count("evict") == 1 and kinds.count("flush") == 2
    evict = next(e for e in events if e.kind == "evict")
    assert evict.data["tenant"] == "x" and evict.data["spilled"] is True
    summary = S.serving.serving_summary()["evbank"]
    assert summary["occupancy"] == 1 and summary["evictions"] == 1 and summary["launches"] == 2
    text = S.obs.prometheus_text()
    families = sorted({line.split("{")[0] for line in text.splitlines() if line.startswith("metrics_tpu_bank_")})
    assert 'metrics_tpu_bank_occupancy{bank="evbank"' in text
    event_data = [
        (e.kind, {k: v for k, v in e.data.items() if k != "ms"}) for e in events
    ]
    summary = {k: v for k, v in summary.items() if k != "flush_ms_ewma"}
    return {"events": event_data, "summary": summary, "families": families}


BANK_CASES = {
    **{f"bit_identity_classification[{k}]": (sc_bit_identity_classification, k) for k in CLS_FACTORIES},
    "bit_identity_aggregation[sum]": (sc_bit_identity_aggregation, "sum"),
    "bit_identity_aggregation[mean]": (sc_bit_identity_aggregation, "mean"),
    "bit_identity_screening_policies[skip]": (sc_bit_identity_screening, "skip"),
    "bit_identity_screening_policies[mask]": (sc_bit_identity_screening, "mask"),
    "bit_identity_pow2_bucketed_ragged_batches": (sc_pow2_bucketed,),
    "mixed_shapes_without_bucketing_rejected": (sc_mixed_shapes_rejected,),
    "launch_amortization_one_launch_per_batch": (sc_launch_amortization,),
    "dense_and_scatter_variants_agree": (sc_dense_and_scatter,),
    "spill_readmit_roundtrips_exactly": (sc_spill_readmit,),
    "lru_eviction_order_deterministic": (sc_lru_order,),
    "duplicate_tenant_in_batch_rejected": (sc_duplicate_tenant_rejected,),
    "batch_exceeding_capacity_rejected": (sc_over_capacity_rejected,),
    "unbankable_templates_rejected": (sc_unbankable,),
    "compute_async_one_coalesced_fetch": (sc_compute_async,),
    "materialize_rides_existing_surfaces": (sc_materialize,),
    "state_spec_matches_bank_slot_layout": (sc_state_spec_layout,),
    "events_and_serving_summary": (sc_events_and_summary,),
}


@pytest.mark.parametrize("case", list(BANK_CASES))
def test_bank_matches_jax(case):
    fn, *args = BANK_CASES[case]
    run_both(fn, *args)


# ---------------------------------------------------------------------------
# tests/serving/test_router.py
# ---------------------------------------------------------------------------
def router_obs(router, bank):
    return {"router": dict(router.stats), "pending": router.pending, "bank": dict(bank.stats)}


def sc_size_flush(S):
    bank = S.bank(S.m("Accuracy", num_classes=NUM_CLASSES), capacity=16)
    router = S.router(bank, max_requests=4, max_delay_s=None)
    flushed = sum(router.submit(f"t{i}", *req(S, i)) for i in range(4))
    assert flushed == 4 and bank.stats["launches"] == 1 and router.pending == 0
    return {**router_obs(router, bank), "tenants": tenant_obs(bank, [f"t{i}" for i in range(4)])}


def sc_ordered_waves(S):
    bank = S.bank(S.m("SumMetric", nan_strategy="disable"), capacity=4)
    router = S.router(bank, max_requests=4, max_delay_s=None)
    solo = S.m("SumMetric", nan_strategy="disable")
    for i in range(3):
        v = ones(S, 4, i + 1.0)
        solo.update(v)
        router.submit("S", v)
    router.flush()
    assert bank.stats["launches"] == 3
    np.testing.assert_array_equal(host(solo._snapshot_state()["value"]), host(bank.tenant_state("S")["value"]))
    return router_obs(router, bank)


def sc_signature_groups(S):
    bank = S.bank(S.m("SumMetric", nan_strategy="disable"), capacity=8)
    router = S.router(bank, max_requests=8, max_delay_s=None)
    router.submit("a", ones(S, 4))
    router.submit("b", ones(S, 6))
    router.submit("c", ones(S, 4))
    assert router.pending == 3
    router.flush()
    assert bank.stats["launches"] == 2 and bank.stats["requests"] == 3
    return router_obs(router, bank)


def sc_pow2_grouping(S):
    bank = S.bank(S.m("SumMetric", nan_strategy="disable", jit_bucket="pow2"), capacity=8)
    router = S.router(bank, max_requests=8, max_delay_s=None)
    for i, n in enumerate((5, 7, 8)):
        router.submit(f"t{i}", ones(S, n))
    router.flush()
    assert bank.stats["launches"] == 1 and bank.stats["bucketed_requests"] == 3
    return {**router_obs(router, bank), "tenants": tenant_obs(bank, ["t0", "t1", "t2"])}


def sc_cross_group_order(S):
    bank = S.bank(S.m("SumMetric", nan_strategy="disable"), capacity=8)
    router = S.router(bank, max_requests=8, max_delay_s=None)
    router.submit("T", ones(S, 4))
    assert router.pending == 1
    router.submit("T", ones(S, 6))  # the new group flushes the old one first
    assert bank.stats["launches"] == 1
    first = float(host(bank.compute("T")))
    router.flush()
    assert (first, float(host(bank.compute("T")))) == (4.0, 10.0)
    return router_obs(router, bank)


def sc_compute_async_spilled(S):
    bank = S.bank(S.m("SumMetric", nan_strategy="disable"), capacity=1)
    bank.update("a", ones(S, 4))
    bank.update("b", ones(S, 4))  # spills "a"
    values = bank.compute_async().result()
    assert set(values) == {"a", "b"}
    return host(values)


def sc_deadline_flush(S):
    now = [0.0]
    bank = S.bank(S.m("Accuracy", num_classes=NUM_CLASSES), capacity=8)
    router = S.router(bank, max_requests=100, max_delay_s=1.0, clock=lambda: now[0])
    router.submit("a", *req(S, 1))
    assert router.pending == 1 and router.poll() == 0
    now[0] = 2.0
    assert router.poll() == 1
    assert bank.stats["launches"] == 1 and router.stats["deadline_flushes"] == 1
    return router_obs(router, bank)


def sc_chunk_to_capacity(S):
    bank = S.bank(S.m("Accuracy", num_classes=NUM_CLASSES), capacity=2)
    router = S.router(bank, max_requests=100, max_delay_s=None)
    for i in range(5):
        router.submit(f"t{i}", *req(S, i))
    router.flush()
    assert bank.stats["requests"] == 5 and bank.stats["launches"] == 3
    assert bank.occupancy == 2 and len(bank.spilled_tenants) == 3
    return {**router_obs(router, bank), **bank_obs(bank)}


def sc_starvation(S):
    now = [0.0]
    bank = S.bank(S.m("SumMetric", nan_strategy="disable"), capacity=8)
    router = S.router(bank, max_requests=2, max_delay_s=1.0, clock=lambda: now[0])
    for i in range(4):
        router.submit(f"a{i}", ones(S, 4))
    router.submit("b0", ones(S, 6))
    now[0] = 2.0
    router.poll()
    detail = router.pending_detail()
    assert set(detail) == {"sig0", "sig1"}
    a, b = detail["sig0"], detail["sig1"]
    assert (a["size_flushes"], a["deadline_flushes"], a["submitted"], a["flushed"]) == (2, 0, 4, 4)
    assert (b["size_flushes"], b["deadline_flushes"], b["submitted"], b["flushed"]) == (0, 1, 1, 1)
    assert "[4]" in a["signature"] and "[6]" in b["signature"]
    assert router.pending == 0 and all(d["pending"] == 0 for d in detail.values())
    return {**router_obs(router, bank), "detail": detail}


def sc_pending_detail(S):
    now = [10.0]
    bank = S.bank(S.m("SumMetric", nan_strategy="disable"), capacity=8)
    router = S.router(bank, max_requests=8, max_delay_s=None, clock=lambda: now[0])
    router.submit("a", ones(S, 4))
    router.submit("b", ones(S, 4))
    now[0] = 10.5
    detail = router.pending_detail()
    assert detail["sig0"]["pending"] == 2 and detail["sig0"]["oldest_wait_s"] == pytest.approx(0.5)
    return detail


def sc_drain_pending(S):
    bank = S.bank(S.m("SumMetric", nan_strategy="disable"), capacity=8)
    router = S.router(bank, max_requests=100, max_delay_s=None)
    v1, v2 = ones(S, 4, 1.0), ones(S, 4, 2.0)
    router.submit("T", v1, request_id="r1")
    router.submit("T", v2)
    router.submit("U", v1)
    drained = router.drain_pending()
    assert router.pending == 0 and bank.stats["launches"] == 0
    t_vals = [float(host(args[0])[0]) for t, args, _rid in drained if t == "T"]
    assert t_vals == [1.0, 2.0]
    ids = {(t, rid) for t, _args, rid in drained}
    assert ("T", "r1") in ids and ("U", None) in ids
    return {"drained": [(t, host(args[0]), rid) for t, args, rid in drained], **router_obs(router, bank)}


def sc_sig_overflow(S):
    bank = S.bank(S.m("SumMetric", nan_strategy="disable"), capacity=64)
    clock = [0.0]
    router = S.router(bank, max_requests=64, max_delay_s=None, clock=lambda: clock[0])
    router._SIG_STATS_CAP = 8
    for i in range(12):
        clock[0] = float(i)
        router.submit(f"t{i}", ones(S, i + 1))
    assert len(router._sig_labels) == 8
    assert set(router._sig_stats) == {f"sig{i}" for i in range(8)} | {"sig_other"}
    detail = router.pending_detail()
    assert len(detail) == 9 and detail["sig_other"]["pending"] == 4
    clock[0] = 20.0
    detail = router.pending_detail()
    assert detail["sig_other"]["oldest_wait_s"] == pytest.approx(12.0)
    router.flush()
    flushed = sum(e["flushed"] for e in router.pending_detail().values())
    assert flushed == 12 and router._sig_stats["sig_other"]["flushed"] == 4
    for i in range(4):
        clock[0] = 30.0 + i
        router.submit(f"u{i}", ones(S, 20 + i))
    assert len(router._sig_labels) == 8 and len(router._sig_stats) == 9
    assert router._sig_stats["sig_other"]["submitted"] == 8
    router.drain_pending()
    return {"detail": detail, "sig_stats": router._sig_stats, **router_obs(router, bank)}


def sc_request_ids_dedup(S):
    dedup = S.serving.RequestDedup()
    bank_a = S.bank(S.m("SumMetric", nan_strategy="disable"), capacity=4, request_dedup=dedup)
    bank_b = S.bank(S.m("SumMetric", nan_strategy="disable"), capacity=4, request_dedup=dedup)
    router_a = S.router(bank_a, max_requests=8, max_delay_s=None)
    router_b = S.router(bank_b, max_requests=8, max_delay_s=None)
    v = ones(S, 4, 3.0)
    router_a.submit("T", v, request_id="r1")
    router_b.submit("T", v, request_id="r1")  # the hedged twin
    router_a.flush()
    assert float(host(bank_a.tenant_state("T")["value"])) == 12.0
    assert router_b.flush() == 1 and router_b.pending == 0
    assert bank_b.occupancy == 0 and bank_b.stats["dedup_dropped"] == 1
    summary = dedup.summary()
    assert summary["duplicates_dropped"] == 1 and summary["duplicates_applied"] == 0
    return {"dedup": summary, "a": router_obs(router_a, bank_a), "b": router_obs(router_b, bank_b)}


def sc_injected_flush_error(S):
    dedup = S.serving.RequestDedup()
    bank = S.bank(S.m("SumMetric", nan_strategy="disable"), capacity=4, request_dedup=dedup)
    router = S.router(bank, max_requests=8, max_delay_s=None)
    boom = [True]

    def injector():
        if boom[0]:
            boom[0] = False
            raise ConnectionError("UNAVAILABLE: injected")

    bank.fault_injector = injector
    router.submit("T", ones(S, 4, 2.0), request_id="r1")
    with pytest.raises(ConnectionError):
        router.flush()
    assert router.pending == 1 and bank.stats["flush_errors"] == 1
    assert bank.occupancy == 0 and dedup.summary()["claims"] == 0
    assert router.flush() == 1
    assert float(host(bank.tenant_state("T")["value"])) == 8.0 and dedup.is_applied("T", "r1")
    return {"dedup": dedup.summary(), **router_obs(router, bank)}


def sc_failed_dispatch_releases(S, dispatch_name):
    dedup = S.serving.RequestDedup()
    bank = S.bank(S.m("SumMetric", nan_strategy="disable"), capacity=4, request_dedup=dedup)
    router = S.router(bank, max_requests=8, max_delay_s=None)
    orig = getattr(bank, dispatch_name)
    calls = [0]

    def flaky(*args, **kwargs):
        if calls[0] == 0:
            calls[0] += 1
            raise RuntimeError("launch failed")
        return orig(*args, **kwargs)

    setattr(bank, dispatch_name, flaky)
    router.submit("T", ones(S, 4, 2.0), request_id="r1")
    with pytest.raises(RuntimeError, match="launch failed"):
        router.flush()
    assert router.pending == 1 and bank.stats["flush_errors"] == 1 and dedup.summary()["aborts"] == 1
    assert router.flush() == 1
    assert float(host(bank.tenant_state("T")["value"])) == 8.0
    assert dedup.is_applied("T", "r1") and dedup.summary()["duplicates_applied"] == 0
    return {"dedup": dedup.summary(), **router_obs(router, bank)}


def sc_caller_validation(S):
    bank = S.bank(S.m("SumMetric", nan_strategy="disable"), capacity=2)
    v = ones(S, 4)
    with pytest.raises(ValueError, match="exceeds bank capacity"):
        bank.apply_batch([(f"t{i}", (v,)) for i in range(3)])
    with pytest.raises(ValueError, match="multiple requests for one tenant"):
        bank.apply_batch([("t", (v,)), ("t", (v,))])
    with pytest.raises(ValueError, match="must align"):
        bank.apply_batch([("t", (v,))], request_ids=["a", "b"])
    assert bank.stats["flush_errors"] == 0
    return dict(bank.stats)


# the JAX bank's dispatch seam, and the port's
_DISPATCH = {"jax": "_dispatch_scatter", "torch": "_dispatch_wave"}

ROUTER_CASES = {
    "size_flush_batches_requests_into_one_launch": (sc_size_flush,),
    "same_tenant_requests_split_into_ordered_waves": (sc_ordered_waves,),
    "signature_groups_keep_shapes_apart": (sc_signature_groups,),
    "pow2_bucket_grouping_shares_a_wave": (sc_pow2_grouping,),
    "cross_group_submissions_preserve_per_tenant_order": (sc_cross_group_order,),
    "compute_async_default_covers_spilled_tenants": (sc_compute_async_spilled,),
    "deadline_flush_uses_injected_clock": (sc_deadline_flush,),
    "oversized_wave_chunks_to_capacity": (sc_chunk_to_capacity,),
    "per_signature_deadline_flush_counts_surface_starvation": (sc_starvation,),
    "pending_detail_reports_live_queue_and_wait": (sc_pending_detail,),
    "drain_pending_returns_requests_in_per_tenant_order": (sc_drain_pending,),
    "sig_stats_overflow_folds_into_bounded_sig_other": (sc_sig_overflow,),
    "request_ids_flow_to_the_banks_dedup": (sc_request_ids_dedup,),
    "injected_flush_error_requeues_tagged_request_before_any_claim": (sc_injected_flush_error,),
    "caller_validation_errors_are_not_worker_sickness": (sc_caller_validation,),
}


@pytest.mark.parametrize("case", list(ROUTER_CASES) + ["failed_dispatch_releases_dedup_claims_for_retry"])
def test_router_matches_jax(case):
    if case == "failed_dispatch_releases_dedup_claims_for_retry":
        out = {name: sc_failed_dispatch_releases(Side(name), _DISPATCH[name]) for name in SIDES}
        same(out["jax"], out["torch"])
        return
    fn, *args = ROUTER_CASES[case]
    run_both(fn, *args)


# ---------------------------------------------------------------------------
# tests/serving/test_pod_bank.py, the single-device part
# ---------------------------------------------------------------------------
POD_CLASSES = 8


def sc_drive_matches_per_flush(S):
    steps = [int_req(S, i) for i in range(6)]
    driven = S.bank(S.m("Accuracy", num_classes=POD_CLASSES), capacity=2)
    flushed = S.bank(S.m("Accuracy", num_classes=POD_CLASSES), capacity=2)
    S.engine.drive_bank(driven, "e", steps)
    assert driven.stats["launches"] == 1 and driven.stats["bank_drives"] == 1 and driven.stats["drive_steps"] == 6
    for s in steps:
        flushed.update("e", *s)
    np.testing.assert_array_equal(host(driven.compute("e")), host(flushed.compute("e")))
    assert driven.update_count("e") == 6
    return {"driven": bank_obs(driven), "flushed": bank_obs(flushed)}


def sc_drive_ragged_pow2(S):
    template = S.m("Accuracy", num_classes=POD_CLASSES, jit_bucket="pow2")
    rng = np.random.RandomState(3)
    steps = [
        (S.arr(rng.randint(0, POD_CLASSES, size=n).astype(np.int32)), S.arr(rng.randint(0, POD_CLASSES, size=n).astype(np.int32)))
        for n in (8, 6, 8, 5, 7)
    ]
    driven = S.bank(template, capacity=2)
    solo = template.clone()
    driven.drive("e", steps)
    for s in steps:
        solo.update(*s)
    assert driven.stats["launches"] == 1 and driven.stats["bucketed_requests"] == 5
    np.testing.assert_array_equal(host(driven.compute("e")), host(solo.compute()))
    return bank_obs(driven)


def _prob_req(S, seed, batch=8, nan_rows=0):
    rng = np.random.RandomState(seed)
    preds = rng.rand(batch, POD_CLASSES).astype(np.float32)
    if nan_rows:
        preds[:nan_rows, 0] = np.nan
    return S.arr(preds), S.arr(rng.randint(0, POD_CLASSES, size=batch).astype(np.int32))


def sc_drive_screening(S):
    template = S.m("Accuracy", num_classes=POD_CLASSES, on_bad_input="skip")
    steps = [_prob_req(S, i, nan_rows=2 if i % 2 else 0) for i in range(5)]
    driven = S.bank(template, capacity=2)
    solo = template.clone()
    driven.drive("e", steps)
    for s in steps:
        solo.update(*s)
    states_equal_solo(driven, "e", solo)
    return bank_obs(driven)


def _pod_collection(S):
    return S.coll({"acc": S.m("Accuracy", num_classes=POD_CLASSES), "cm": S.m("ConfusionMatrix", num_classes=POD_CLASSES)})


def sc_drive_rejects_collections(S):
    bank = S.bank(_pod_collection(S), capacity=2)
    with pytest.raises(S.exc.MetricsUserError) as err:
        bank.drive("e", [int_req(S, 0)])
    return str(err.value)


def sc_collection_bank(S):
    bank = S.bank(_pod_collection(S), capacity=2)
    tenants = [f"u{i}" for i in range(4)]
    solos = {t: _pod_collection(S) for t in tenants}
    for step in range(3):
        for j, t in enumerate(tenants):
            r = int_req(S, 17 * step + j)
            solos[t].update(*r)
            bank.update(t, *r)
    for t in tenants:
        got, want = bank.compute(t), solos[t].compute()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(host(got[k]), host(want[k]), err_msg=f"{t}:{k}")
    return bank_obs(bank)


def sc_router_collection_wave(S):
    bank = S.bank(_pod_collection(S), capacity=8)
    assert bank.signature_token() is not None
    router = S.router(bank, max_requests=4, max_delay_s=None)
    for i in range(4):
        router.submit(f"t{i}", *int_req(S, i))
    assert router.pending == 0 and bank.stats["launches"] == 1 and bank.stats["requests"] == 4
    return {**router_obs(router, bank), **bank_obs(bank)}


POD_CASES = {
    "bank_drive_matches_per_flush_bit_identically": (sc_drive_matches_per_flush,),
    "bank_drive_ragged_pow2_tail_bit_identical": (sc_drive_ragged_pow2,),
    "bank_drive_screening_bit_identical_to_per_flush": (sc_drive_screening,),
    "bank_drive_rejects_collections": (sc_drive_rejects_collections,),
    "collection_bank_bit_identical_to_solo_collections": (sc_collection_bank,),
    "router_folds_collection_signature_into_one_wave": (sc_router_collection_wave,),
}


@pytest.mark.parametrize("case", list(POD_CASES))
def test_single_device_pod_bank_matches_jax(case):
    fn, *args = POD_CASES[case]
    run_both(fn, *args)


# ---------------------------------------------------------------------------
# more of the bank's surface, on both packages
# ---------------------------------------------------------------------------
def _prob_collection(S, **kw):
    return S.coll({"acc": S.m("Accuracy", num_classes=POD_CLASSES, **kw), "cm": S.m("ConfusionMatrix", num_classes=POD_CLASSES, **kw)})


def sc_collection_export_import(S):
    src = S.bank(_prob_collection(S), capacity=2, name="src")
    dest = S.bank(_prob_collection(S), capacity=2, name="dest")
    for step in range(2):
        for j, t in enumerate(("a", "b", "c")):
            src.update(t, *_prob_req(S, 10 * step + j))
    payload = src.export_payload("b", keep=True)
    tree = src.export_tenant("a")
    dest.import_tenant("a", tree)
    dest.import_tenant("b", S.store.decode_tenant_payload(payload), admit=False)
    dest.update("a", *_prob_req(S, 99))
    assert "a" not in src.tenants + src.spilled_tenants and dest.spilled_tenants == ["b"]
    return {"payload": payload, "tree": host(tree), "src": bank_obs(src), "dest": bank_obs(dest)}


def sc_cadence_and_lag(S):
    bank = S.bank(S.m("Accuracy", num_classes=NUM_CLASSES), capacity=4, name="lag")
    lags = []
    for step in range(3):
        bank.apply_batch([(t, req(S, 10 * step + i)) for i, t in enumerate(("a", "b"))])
        lags.append(bank.checkpoint_lag())
    bank.set_checkpoint_cadence(2)
    assert bank.checkpoint_cadence == 2
    for step in range(3, 6):
        bank.apply_batch([(t, req(S, 10 * step + i)) for i, t in enumerate(("a", "b"))])
        lags.append(bank.checkpoint_lag())
    with pytest.raises(ValueError):
        bank.set_checkpoint_cadence(0)
    return {"lags": lags, **bank_obs(bank)}


def sc_collection_pow2_router(S):
    make = lambda: _prob_collection(S, jit_bucket="pow2")  # noqa: E731
    bank = S.bank(make(), capacity=8)
    router = S.router(bank, max_requests=8, max_delay_s=None)
    solos = {}
    for i, n in enumerate((5, 7, 8, 3)):
        r = _prob_req(S, 40 + i, batch=n)
        solos.setdefault(f"t{i % 3}", make()).update(*r)
        router.submit(f"t{i % 3}", *r)
    router.flush()
    assert bank.stats["bucketed_requests"] == 4 and bank.stats["launches"] == 2
    for t, solo in solos.items():
        got, want = bank.compute(t), solo.compute()
        for k in want:
            np.testing.assert_array_equal(host(got[k]), host(want[k]), err_msg=f"{t}:{k}")
    return {**router_obs(router, bank), **bank_obs(bank)}


def sc_collection_screening(S, policy):
    make = lambda: _prob_collection(S, on_bad_input=policy)  # noqa: E731
    bank = S.bank(make(), capacity=2)
    solos = {t: make() for t in ("a", "b", "c")}
    for step in range(3):
        for j, t in enumerate(solos):
            r = _prob_req(S, 7 * step + j, nan_rows=2 if (step + j) % 2 else 0)
            solos[t].update(*r)
            bank.update(t, *r)
    for t, solo in solos.items():
        got, want = bank.compute(t), solo.compute()
        for k in want:
            np.testing.assert_array_equal(host(got[k]), host(want[k]), err_msg=f"{t}:{k}")
    summary = bank.summary()
    keys = ("nan_count", "inf_count", "rows_masked", "updates_quarantined", "quarantine_rate")
    return {**bank_obs(bank), "health": {k: summary[k] for k in keys}}


MORE_CASES = {
    "collection_export_import": (sc_collection_export_import,),
    "checkpoint_cadence_and_lag": (sc_cadence_and_lag,),
    "collection_pow2_router": (sc_collection_pow2_router,),
    "collection_screening[skip]": (sc_collection_screening, "skip"),
    "collection_screening[mask]": (sc_collection_screening, "mask"),
}


@pytest.mark.parametrize("case", list(MORE_CASES))
def test_more_bank_surface_matches_jax(case):
    fn, *args = MORE_CASES[case]
    run_both(fn, *args)


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------
class _Boom(Exception):
    pass


def test_failed_mid_wave_flush_leaves_the_bank_unchanged():
    """A member whose third transition of a wave raises: the wave is counted
    as a flush error and every row, count and stat of the bank is as before."""
    import metrics_tpu_torch as mt
    from metrics_tpu_torch.serving import MetricBank

    S = Side("torch")
    coll = S.coll({"acc": S.m("Accuracy", num_classes=NUM_CLASSES), "cm": S.m("ConfusionMatrix", num_classes=NUM_CLASSES)})
    bank = MetricBank(coll, capacity=8, name="midwave")
    tenants = [f"t{i}" for i in range(4)]
    bank.apply_batch([(t, req(S, i)) for i, t in enumerate(tenants)])
    before = {t: host(bank.tenant_state(t)) for t in tenants}
    resident = {n: leaf.clone() for n, leaf in bank._resident.items()}
    counts, stats = dict(bank._counts), dict(bank.stats)
    cm = bank._members[1]
    inner = cm._inner_update
    calls = [0]

    def failing(*args, **kwargs):
        calls[0] += 1
        if calls[0] == 3:
            raise _Boom("the third request's transition fails")
        return inner(*args, **kwargs)

    cm._inner_update = failing
    with pytest.raises(_Boom):
        bank.apply_batch([(t, req(S, 10 + i)) for i, t in enumerate(tenants)])
    cm._inner_update = inner
    assert calls[0] == 3
    for n, leaf in bank._resident.items():
        assert torch.equal(leaf, resident[n]), n
    for t in tenants:
        same(before[t], host(bank.tenant_state(t)), t)
    assert bank._counts == counts
    assert bank.stats == {**stats, "flush_errors": stats["flush_errors"] + 1}
    # the bank still serves: the retried wave applies once
    bank.apply_batch([(t, req(S, 10 + i)) for i, t in enumerate(tenants)])
    solo = mt.MetricCollection({"acc": S.m("Accuracy", num_classes=NUM_CLASSES), "cm": S.m("ConfusionMatrix", num_classes=NUM_CLASSES)})
    solo.update(*req(S, 0))
    solo.update(*req(S, 10))
    got = bank.compute("t0")
    for k, v in solo.compute().items():
        np.testing.assert_array_equal(host(got[k]), host(v))


@pytest.mark.parametrize("program", ["wave", "scan"])
def test_warm_up_ahead_of_a_capture_writes_nothing(program):
    """On the card a bank program's warm-up (``warm_up=True``) runs ahead of
    its capture, and the first replay runs the wave: the warm-up runs the
    first request's transition, returns nothing and leaves every row of the
    bank as it was, so a refused capture cannot have changed the bank. The
    program itself writes no row either: it returns the new rows, which the
    bank writes back once the wave succeeded."""
    from metrics_tpu_torch.engine import cache
    from metrics_tpu_torch.serving import MetricBank
    from metrics_tpu_torch.utils.program import program_scope

    S = Side("torch")
    bank = MetricBank(S.m("ConfusionMatrix", num_classes=NUM_CLASSES), capacity=4, name=f"warm_up_{program}")
    bank.apply_batch([(t, req(S, i)) for i, t in enumerate("ab")])
    reqs = [req(S, 20), req(S, 21)]
    args = tuple(torch.stack([r[j] for r in reqs]) for j in range(2))
    if program == "wave":
        fn = cache.bank_entry(bank._template)._fns["wave"]
        inputs = (torch.tensor([bank._slots["a"], bank._slots["b"]]), args, {})
    else:
        fn = cache.bank_drive_entry(bank._template)._fns["scan"]
        inputs = (torch.tensor([bank._slots["a"]]), 2, args, {})
    before = {n: leaf.clone() for n, leaf in bank._resident.items()}
    inner = bank._template._inner_update
    calls = [0]

    def counted(*a, **k):
        calls[0] += 1
        return inner(*a, **k)

    bank._template._inner_update = counted
    with program_scope():
        assert fn(bank._template, bank._resident, *inputs, warm_up=True) is None
        assert calls[0] == 1
        for n, leaf in bank._resident.items():
            assert torch.equal(leaf, before[n]), n
        out = fn(bank._template, bank._resident, *inputs)
        for n, leaf in bank._resident.items():
            assert torch.equal(leaf, before[n]), n
    bank._template._inner_update = inner
    assert calls[0] == 3
    rows = out if program == "wave" else {n: v.unsqueeze(0) for n, v in out.items()}
    bank._write_back((inputs[0], rows))
    assert any(not torch.equal(bank._resident[n], before[n]) for n in before)


def test_snapshots_are_copies_a_later_wave_cannot_change():
    """The bank is written in place, so every row handed out is a copy."""
    S = Side("torch")
    bank = S.bank(S.m("ConfusionMatrix", num_classes=NUM_CLASSES), capacity=4)
    bank.update("a", *req(S, 0))
    state = bank.tenant_state("a")
    value = bank.compute("a")
    handle = bank.compute_async(["a"])
    kept = {n: v.clone() for n, v in state.items()}
    bank.update("a", *req(S, 1))
    for n, v in state.items():
        assert torch.equal(v, kept[n]), n
    assert torch.equal(handle.result()["a"], value)
    assert not torch.equal(bank.compute("a"), value)


def test_unported_options_raise_with_their_messages(tmp_path):
    from metrics_tpu_torch.serving import MetricBank, OrbaxStore
    from metrics_tpu_torch.utils.exceptions import MetricsUserError

    S = Side("torch")
    # pod-scale banks are ported: what is left raises the JAX package's errors
    with pytest.raises(MetricsUserError, match="named dims"):
        MetricBank(S.m("Accuracy", num_classes=NUM_CLASSES), capacity=2, mesh=object(), tenant_axis="host")
    with pytest.raises(MetricsUserError, match="needs mesh= too"):
        MetricBank(S.m("Accuracy", num_classes=NUM_CLASSES), capacity=2, tenant_axis="host")
    with pytest.raises(MetricsUserError, match="orbax-checkpoint") as err:
        OrbaxStore(str(tmp_path / "orbax"))
    assert "DiskStore" in str(err.value)


def test_serving_root_matches_jax():
    import metrics_tpu as mj
    import metrics_tpu_torch as mt

    assert mt.serving.__all__ == mj.serving.__all__
    for name in mj.serving.__all__:
        assert hasattr(mt.serving, name), name
    assert mt.engine.drive_bank.__name__ == "drive_bank"
    bank = mt.serving.MetricBank(mt.ConfusionMatrix(num_classes=3, device="cpu"), capacity=2, name="keys")
    jbank = mj.serving.MetricBank(mj.ConfusionMatrix(num_classes=3), capacity=2, name="keys")
    assert set(bank.summary()) == set(jbank.summary())
    assert set(mt.serving.durability_stats()) == set(mj.serving.durability_stats())


def test_sync_bank_states_refuses_other_reductions():
    from metrics_tpu.parallel import comm as jcomm
    from metrics_tpu_torch.parallel import comm

    bank = {"value": torch.zeros(4, 3)}
    with pytest.raises(ValueError) as port_err:
        comm.sync_bank_states(bank, {"value": "cat"}, "dp")
    with pytest.raises(ValueError) as jax_err:
        jcomm.sync_bank_states({"value": np.zeros((4, 3))}, {"value": "cat"}, "dp")
    assert str(port_err.value) == str(jax_err.value)


# ---------------------------------------------------------------------------
# sync_bank_states on a two-rank gloo world
# ---------------------------------------------------------------------------
def _bank_sync_inputs():
    rng = np.random.RandomState(7)
    return {
        "value": (np.arange(2 * 4 * 3, dtype=np.int64).reshape(2, 4, 3) * 1000003),
        "peak": rng.randint(-(2**20), 2**20, size=(2, 4, 5)).astype(np.int64),
        "mean": rng.normal(size=(2, 4, 2)).astype(np.float32),
    }


def _bank_sync_worker(rank: int, port: int, out_path: str) -> None:
    sys.path.insert(0, REPO)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import metrics_tpu_torch as mt
    from metrics_tpu_torch.parallel import comm

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank, timeout=timedelta(seconds=60))
    x = _bank_sync_inputs()
    mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("dp",))
    reductions = {"value": "sum", "peak": "max", "mean": "mean"}
    local = {n: torch.from_numpy(v[rank].copy()) for n, v in x.items()}
    with comm.axis_env(mesh):
        flat = comm.sync_bank_states(dict(local), reductions, "dp")
        hier = comm.sync_bank_states(dict(local), reductions, ("dp",), hierarchical=True)
    # a bank's sync_state_in_trace: every rank holds the same tenants in the same slots
    bank = mt.serving.MetricBank(mt.SumMetric(nan_strategy="disable", device="cpu"), capacity=4, name="replicated")
    for i in range(4):
        bank.update(f"t{i}", torch.full((3,), float(rank + i)))
    bank.sync_state_in_trace("dp", mesh=mesh)
    out = {"flat": flat, "hier": hier, "bank": {f"t{i}": bank.compute(f"t{i}") for i in range(4)}}
    torch.save(out, out_path)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_world(tmp) -> list:
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": REPO}
    procs, paths = [], []
    for rank in range(2):
        path = str(tmp / f"rank{rank}.pt")
        log = open(tmp / f"rank{rank}.log", "w+")
        cmd = [sys.executable, os.path.abspath(__file__), str(rank), str(port), path]
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


def test_sync_bank_states_two_rank_gloo_world_matches_jax(tmp_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from metrics_tpu.parallel import comm as jcomm

    x = _bank_sync_inputs()
    reductions = {"value": "sum", "peak": "max", "mean": "mean"}
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))

    def body(value, peak, mean):
        out = jcomm.sync_bank_states({"value": value[0], "peak": peak[0], "mean": mean[0]}, reductions, "dp")
        return out["value"], out["peak"], out["mean"]

    smap = getattr(jax, "shard_map", None)
    if smap is None:
        from jax.experimental.shard_map import shard_map as smap
    want = smap(body, mesh=mesh, in_specs=(P("dp"),) * 3, out_specs=(P(),) * 3)(*(jnp.asarray(x[n]) for n in ("value", "peak", "mean")))
    want = dict(zip(("value", "peak", "mean"), (np.asarray(w) for w in want)))
    ranks = _run_world(tmp_path)
    for rec in ranks:
        for key in ("flat", "hier"):
            np.testing.assert_array_equal(rec[key]["value"].numpy(), want["value"])
            np.testing.assert_array_equal(rec[key]["peak"].numpy(), want["peak"])
            np.testing.assert_allclose(rec[key]["mean"].numpy(), want["mean"], rtol=FLOAT_RTOL)
        for key in ("value", "peak", "mean"):
            assert torch.equal(rec["hier"][key], rec["flat"][key]), key
        for i in range(4):
            # each rank's row i summed (rank + i) over 3 elements
            assert float(rec["bank"][f"t{i}"]) == 3.0 * ((0 + i) + (1 + i))


if __name__ == "__main__":
    _bank_sync_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])

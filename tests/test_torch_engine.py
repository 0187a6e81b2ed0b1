"""The port's update engine (``metrics_tpu_torch.engine``) against the JAX
package's (``metrics_tpu.engine``) on the same numpy inputs, on the CPU:
pow2 bucketing, the shared program cache and its telemetry, the fused
collection programs, the eager fallback, and the value checks inside a
program. It mirrors ``tests/engine/test_bucketing.py`` and
``tests/engine/test_compile_cache.py``.

Tolerances: integer counts bit for bit; float sums within 1e-5 relative
(the x64 JAX lane keeps float64 states where the port keeps float32, and
padding changes the order of the additions); scores within 1e-6 relative.
"""
import copy
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mj
import metrics_tpu_torch as mt
from metrics_tpu import engine as ej
from metrics_tpu_torch import engine as et

RAGGED = [7, 1, 33, 100, 257, 64]
C = 5


@pytest.fixture(autouse=True)
def _fresh_caches():
    ej.clear_cache()
    et.clear_cache()
    yield
    ej.clear_cache()
    et.clear_cache()


def _cls_batches(seed, sizes, c=C):
    rng = np.random.RandomState(seed)
    return [(rng.rand(n, c).astype(np.float32), rng.randint(0, c, size=(n,)).astype(np.int64)) for n in sizes]


def _port(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _jax(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _assert_close(got, want, rtol=1e-6):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


def _assert_states(port_m, jax_m, rtol=1e-5):
    assert set(port_m._defaults) == set(jax_m._defaults)
    for name in port_m._defaults:
        _assert_close(getattr(port_m, name), getattr(jax_m, name), rtol=rtol)


def _assert_same_states(a, b, exact=True):
    for name in a._defaults:
        x, y = getattr(a, name), getattr(b, name)
        if exact or not x.is_floating_point():
            assert torch.equal(x, y), name
        else:
            torch.testing.assert_close(x, y, rtol=1e-6, atol=0)


CLS_FACTORIES = {
    "accuracy": lambda pkg, **kw: pkg.Accuracy(num_classes=C, **kw),
    "accuracy_top_k": lambda pkg, **kw: pkg.Accuracy(num_classes=C, top_k=2, **kw),
    "confmat": lambda pkg, **kw: pkg.ConfusionMatrix(num_classes=C, **kw),
    "stat_scores_macro": lambda pkg, **kw: pkg.StatScores(reduce="macro", num_classes=C, **kw),
    "f1": lambda pkg, **kw: pkg.F1Score(num_classes=C, average="macro", **kw),
}


@pytest.mark.parametrize("name", list(CLS_FACTORIES))
def test_bucketed_classification_bitwise_parity(name):
    """Integer counts under pow2 padding equal the unpadded eager counts and
    the JAX bucketed counts bit for bit, at every ragged batch."""
    factory = CLS_FACTORIES[name]
    bucketed = factory(mt, jit_bucket="pow2", device="cpu")
    eager = factory(mt, jit_update=False, device="cpu")
    jax_m = factory(mj, jit_bucket="pow2")
    for p, t in _cls_batches(0, RAGGED):
        bucketed.update(*_port(p, t))
        eager.update(*_port(p, t))
        jax_m.update(*_jax(p, t))
        _assert_same_states(bucketed, eager)
        _assert_states(bucketed, jax_m)
    assert bucketed.compile_stats()["bucketed_calls"] == jax_m.compile_stats()["bucketed_calls"] == len(RAGGED)
    _assert_close(bucketed.compute(), jax_m.compute())


FLOAT_CASES = {
    "mse": (lambda pkg, **kw: pkg.MeanSquaredError(**kw), 2),
    "mae": (lambda pkg, **kw: pkg.MeanAbsoluteError(**kw), 2),
    "sum": (lambda pkg, **kw: pkg.SumMetric(nan_strategy="disable", **kw), 1),
    "weighted_mean": (lambda pkg, **kw: pkg.MeanMetric(nan_strategy="disable", **kw), 2),
}


@pytest.mark.parametrize("name", list(FLOAT_CASES))
def test_bucketed_float_sums_parity(name):
    factory, n_args = FLOAT_CASES[name]
    bucketed = factory(mt, jit_bucket="pow2", device="cpu")
    eager = factory(mt, jit_update=False, device="cpu")
    jax_m = factory(mj, jit_bucket="pow2")
    rng = np.random.RandomState(1)
    for n in RAGGED:
        args = [rng.rand(n).astype(np.float32) for _ in range(n_args)]
        bucketed.update(*_port(*args))
        eager.update(*_port(*args))
        jax_m.update(*_jax(*args))
    assert bucketed.compile_stats()["bucketed_calls"] == len(RAGGED)
    _assert_same_states(bucketed, eager, exact=False)
    _assert_states(bucketed, jax_m)
    _assert_close(bucketed.compute(), jax_m.compute(), rtol=1e-5)


def test_retrace_cap_is_one_program_per_bucket():
    """7/1000/8192/900/6 rows under pow2 bucketing: one program per bucket
    {8, 1024, 8192}; a second instance streaming the same shapes creates
    none, as in the JAX engine."""
    sizes = [7, 1000, 8192, 900, 6]
    port_m = mt.Accuracy(num_classes=3, jit_bucket="pow2", device="cpu")
    jax_m = mj.Accuracy(num_classes=3, jit_bucket="pow2")
    for p, t in _cls_batches(2, sizes, c=3):
        port_m.update(*_port(p, t))
        jax_m.update(*_jax(p, t))
    buckets = {et.next_pow2(n) for n in sizes}
    assert port_m.compile_stats()["compiles"] == len(buckets)
    assert len(buckets) <= jax_m.compile_stats()["compiles"] <= len(buckets) + 1
    assert port_m.compile_stats()["compiles"] <= math.ceil(math.log2(max(sizes))) + 1
    twin = mt.Accuracy(num_classes=3, jit_bucket="pow2", device="cpu")
    for p, t in _cls_batches(3, sizes, c=3):
        twin.update(*_port(p, t))
    assert twin.compile_stats()["compiles"] == 0
    assert twin.compile_stats()["cache_hits"] == len(sizes)
    _assert_states(port_m, jax_m)


def test_bucketed_preserves_nonfinite_accumulators():
    """±inf through a bucketed sum survives as it does eagerly, at a pow2
    batch and a ragged one: the correction never makes NaN."""
    for n in (4, 7):
        bucketed = mt.SumMetric(nan_strategy="disable", jit_bucket="pow2", device="cpu")
        x = np.array([1.0, np.inf, 2.0, 3.0, -1.0, 0.5, 4.0][:n], np.float32)
        bucketed.update(torch.from_numpy(x))
        jax_m = mj.SumMetric(nan_strategy="disable", jit_bucket="pow2")
        jax_m.update(jnp.asarray(x))
        assert bucketed.compile_stats()["bucketed_calls"] == 1
        assert float(bucketed.compute()) == float(jax_m.compute()) == float("inf")


@pytest.mark.parametrize("case", ["max_metric", "macro_ignore_index"])
def test_non_additive_metrics_keep_exact_shapes(case):
    """MaxMetric and macro reduce with ignore_index are not row-additive:
    ``jit_bucket`` does nothing for them, in both packages."""
    if case == "max_metric":
        make = lambda pkg, **kw: pkg.MaxMetric(nan_strategy="disable", **kw)  # noqa: E731
        rng = np.random.RandomState(5)
        batches = [(rng.rand(n).astype(np.float32),) for n in (7, 33)]
    else:
        make = lambda pkg, **kw: pkg.Accuracy(num_classes=C, average="macro", ignore_index=1, **kw)  # noqa: E731
        batches = _cls_batches(6, [7, 33])
    port_m, jax_m = make(mt, jit_bucket="pow2", device="cpu"), make(mj, jit_bucket="pow2")
    eager = make(mt, jit_update=False, device="cpu")
    for batch in batches:
        port_m.update(*_port(*batch))
        eager.update(*_port(*batch))
        jax_m.update(*_jax(*batch))
    assert port_m.compile_stats()["bucketed_calls"] == jax_m.compile_stats()["bucketed_calls"] == 0
    assert port_m.compile_stats()["compiles"] == len(batches)
    _assert_same_states(port_m, eager)
    _assert_close(port_m.compute(), jax_m.compute())


@pytest.mark.parametrize("kwargs", [{"jit_bucket": "pow3"}, {"on_bad_input": "drop"}])
def test_invalid_engine_options_are_rejected_like_jax(kwargs):
    with pytest.raises(ValueError) as jax_err:
        mj.Accuracy(num_classes=2, **kwargs)
    with pytest.raises(ValueError) as port_err:
        mt.Accuracy(num_classes=2, device="cpu", **kwargs)
    assert str(port_err.value) == str(jax_err.value)


def _collection(pkg, **kw):
    return pkg.MetricCollection(
        {
            "acc": pkg.Accuracy(num_classes=C, **kw),
            "cm": pkg.ConfusionMatrix(num_classes=C, **kw),
            "f1": pkg.F1Score(num_classes=C, average="macro", **kw),
        }
    )


def test_collection_fused_update_buckets():
    """One fused program per bucket {8, 64, 128}, every member corrected
    exactly, equal to the JAX fused collection."""
    sizes = [7, 33, 100, 64]
    fused = _collection(mt, jit_bucket="pow2", device="cpu")
    eager = _collection(mt, jit_update=False, device="cpu")
    jax_mc = _collection(mj, jit_bucket="pow2")
    for p, t in _cls_batches(7, sizes):
        fused.update(*_port(p, t))
        eager.update(*_port(p, t))
        jax_mc.update(*_jax(p, t))
    for key, m in fused.items(keep_base=True):
        _assert_same_states(m, eager[key])
        _assert_states(m, jax_mc[key])
    stats = fused.compile_stats()
    assert stats["bucketed_calls"] == jax_mc.compile_stats()["bucketed_calls"] == len(sizes)
    assert stats["compiles"] == jax_mc.compile_stats()["compiles"] == len({et.next_pow2(n) for n in sizes})
    want = jax_mc.compute()
    for key, value in fused.compute().items():
        _assert_close(value, want[key])


@pytest.mark.parametrize("n", [1, 2, 3, 8, 1000, 1025])
def test_bucketing_helpers_match_jax(n):
    assert et.next_pow2(n) == ej.next_pow2(n)
    p, t = _cls_batches(8, [n])[0]
    port_spec = et.input_spec(_port(p, t), {})
    jax_spec = ej.input_spec(_jax(p, t), {})
    assert port_spec[2] == jax_spec[2] and port_spec[3] == jax_spec[3]
    padded = et.pad_leaves(port_spec[0], port_spec[2], port_spec[3])
    jax_padded = ej.pad_leaves(jax_spec[0], jax_spec[2], jax_spec[3])
    for a, b in zip(padded, jax_padded):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    m = mt.Accuracy(num_classes=C, jit_bucket="pow2", device="cpu")
    assert et.supports_bucketing(m) and et.bucket_spec(m, _port(p, t), {})[3] == port_spec[3]


# ---------------------------------------------------------------------------
# the shared cache
# ---------------------------------------------------------------------------
def _stats_pair(port_m, jax_m):
    keys = ("compiles", "cache_hits", "retraces", "bucketed_calls")
    return {k: port_m.compile_stats()[k] for k in keys}, {k: jax_m.compile_stats()[k] for k in keys}


@pytest.mark.parametrize(
    "case", ["two_instances_share", "different_config", "sync_only_config", "retrace_per_new_shape"]
)
def test_program_sharing_and_counters_match_jax(case):
    """Which instances share a program, and the counters each one reports,
    as in the JAX engine (one Accuracy program per config and shape)."""
    p, t = _cls_batches(0, [16])[0]
    kws = {
        "two_instances_share": ({}, {}),
        "different_config": ({"threshold": 0.3}, {"threshold": 0.7}),
        "sync_only_config": ({"dist_sync_fn": lambda x, group: [x]}, {"dist_sync_fn": lambda x, group: [x]}),
        "retrace_per_new_shape": ({}, None),
    }[case]
    port = [mt.Accuracy(num_classes=C, device="cpu", **kw) for kw in kws if kw is not None]
    jax_ms = [mj.Accuracy(num_classes=C, **kw) for kw in kws if kw is not None]
    if case == "retrace_per_new_shape":
        for n in (8, 16, 8):
            p, t = _cls_batches(6, [n])[0]
            port[0].update(*_port(p, t))
            jax_ms[0].update(*_jax(p, t))
    else:
        for pm, jm in zip(port, jax_ms):
            pm.update(*_port(p, t))
            jm.update(*_jax(p, t))
    for pm, jm in zip(port, jax_ms):
        got, want = _stats_pair(pm, jm)
        assert got == want
        _assert_close(pm.compute(), jm.compute())
    entries = et.cache_summary()["by_kind"]["metric_update"]["entries"]
    assert entries == ej.cache_summary()["by_kind"]["metric_update"]["entries"]


def test_python_init_probe_runs_for_a_cached_instance():
    """An instance served by an existing program still learns ``mode``."""
    p, t = _cls_batches(3, [16])[0]
    m1, m2 = mt.Accuracy(num_classes=C, device="cpu"), mt.Accuracy(num_classes=C, device="cpu")
    m1.update(*_port(p, t))
    m2.update(*_port(p, t))
    assert m2.compile_stats()["compiles"] == 0 and m2.compile_stats()["cache_hits"] == 1
    assert m2.mode is not None
    jax_m = mj.Accuracy(num_classes=C)
    jax_m.update(*_jax(p, t))
    _assert_close(m2.compute(), jax_m.compute())


def test_clones_share_the_program():
    """The first clone of a used metric may key anew (its ``mode`` is in
    its configuration now); every further clone hits the cache."""
    p, t = _cls_batches(4, [16])[0]
    base = mt.Accuracy(num_classes=C, device="cpu")
    base.update(*_port(p, t))
    clone1 = base.clone()
    clone1.update(*_port(p, t))
    assert clone1.compile_stats()["compiles"] <= 1
    clone2 = base.clone()
    clone2.update(*_port(p, t))
    assert clone2.compile_stats() == {**clone2.compile_stats(), "compiles": 0, "cache_hits": 1}
    jax_m = mj.Accuracy(num_classes=C)
    for _ in range(2):
        jax_m.update(*_jax(p, t))
    _assert_close(clone2.compute(), jax_m.compute())


def test_collections_share_fused_programs():
    p, t = _cls_batches(5, [32])[0]
    mc1, mc2 = _collection(mt, device="cpu"), _collection(mt, device="cpu")
    jax_mc1, jax_mc2 = _collection(mj), _collection(mj)
    for pm, jm in ((mc1, jax_mc1), (mc2, jax_mc2)):
        pm.update(*_port(p, t))
        jm.update(*_jax(p, t))
    for pm, jm in ((mc1, jax_mc1), (mc2, jax_mc2)):
        for key in ("compiles", "cache_hits"):
            assert pm.compile_stats()[key] == jm.compile_stats()[key]
    r1, r2, want = mc1.compute(), mc2.compute(), jax_mc1.compute()
    for key in want:
        _assert_close(r1[key], want[key])
        assert torch.equal(r1[key], r2[key])
    by_kind = et.cache_summary()["by_kind"]
    assert by_kind["fused_update"]["entries"] == 1 and by_kind["fused_compute"]["entries"] == 1


class _NanGuard:
    """An update that reads a value on the host: the JAX trace fails on it,
    the port's guard refuses it, and both fall back to the eager update."""

    @staticmethod
    def make(pkg, xp):
        class NanGuard(pkg.Metric):
            def __init__(self, **kw):
                super().__init__(**kw)
                self.add_state("total", xp.zeros(()), dist_reduce_fx="sum")

            def update(self, x):
                if bool(xp.isnan(x).any()):
                    raise RuntimeError("nan")
                self.total = self.total + x.sum()

            def compute(self):
                return self.total

        return NanGuard


def test_eager_fallback_after_a_host_read():
    port_m = _NanGuard.make(mt, torch)(device="cpu")
    jax_m = _NanGuard.make(mj, jnp)()
    for x in ([1.0, 2.0], [3.0]):
        port_m.update(torch.tensor(x))
        jax_m.update(jnp.asarray(x))
    assert port_m._jit_failed and jax_m._jit_failed
    assert port_m.compile_stats()["jit_failed"] is True
    assert float(port_m.compute()) == float(jax_m.compute()) == 6.0


def test_reset_reprobes_fused_compute_exclusions():
    p, t = _cls_batches(9, [16])[0]
    mc = mt.MetricCollection({"acc": mt.Accuracy(num_classes=C, device="cpu"), "cm": mt.ConfusionMatrix(num_classes=C, device="cpu")})
    mc.update(*_port(p, t))
    mc._fused_cmp_excluded["acc"] = mc["acc"]._update_count  # an eviction
    mc.compute()
    assert "acc" in mc._fused_cmp_excluded and mc._fused_cmp_keys == ()
    mc.reset()
    assert mc._fused_cmp_excluded == {}
    mc.update(*_port(p, t))
    out = mc.compute()
    assert set(out) == {"acc", "cm"} and mc._fused_cmp_keys == ("acc", "cm")


def test_a_host_side_compute_is_evicted_from_the_fused_compute():
    """A member whose compute reads the host (R2's observation count) leaves
    the fused compute after one failed probe; the others stay fused and
    every value equals the JAX collection's."""
    rng = np.random.RandomState(11)
    make = lambda pkg, **kw: pkg.MetricCollection(  # noqa: E731
        {"mse": pkg.MeanSquaredError(**kw), "mae": pkg.MeanAbsoluteError(**kw), "r2": pkg.R2Score(**kw)}
    )
    port_mc, jax_mc = make(mt, device="cpu"), make(mj)
    for _ in range(2):
        x, y = rng.rand(20).astype(np.float32), rng.rand(20).astype(np.float32)
        port_mc.update(*_port(x, y))
        jax_mc.update(*_jax(x, y))
    got, want = port_mc.compute(), jax_mc.compute()
    assert set(port_mc._fused_cmp_excluded) == {"r2"} and port_mc._fused_cmp_keys == ("mae", "mse")
    for key in want:
        _assert_close(got[key], want[key], rtol=1e-5)


MAIN_PATH = {
    "top1": lambda pkg, **kw: pkg.Accuracy(num_classes=C, **kw),
    "top3": lambda pkg, **kw: pkg.Accuracy(num_classes=C, top_k=3, **kw),
    "f1": lambda pkg, **kw: pkg.F1Score(num_classes=C, average="macro", **kw),
    "confmat": lambda pkg, **kw: pkg.ConfusionMatrix(num_classes=C, **kw),
}


@pytest.mark.parametrize("path", ["update", "forward", "compute"])
def test_fused_programs_equal_member_by_member_and_jax(path):
    """The fused update, forward and compute of the main-path collection
    equal each member on its own (eager) and the JAX fused collection."""
    fused = mt.MetricCollection({k: f(mt, device="cpu") for k, f in MAIN_PATH.items()})
    single = {k: f(mt, jit_update=False, device="cpu") for k, f in MAIN_PATH.items()}
    jax_mc = mj.MetricCollection({k: f(mj) for k, f in MAIN_PATH.items()})
    for p, t in _cls_batches(10, [16, 16, 9]):
        if path == "forward":
            got = fused(*_port(p, t))
            want = jax_mc(*_jax(p, t))
            for k, m in single.items():
                _assert_close(got[k], m(*_port(p, t)).numpy())
                _assert_close(got[k], want[k])
        else:
            fused.update(*_port(p, t))
            jax_mc.update(*_jax(p, t))
            for m in single.values():
                m.update(*_port(p, t))
    assert fused._fused_fwd_keys == (tuple(sorted(MAIN_PATH)) if path == "forward" else ())
    assert fused._fused_keys == (() if path == "forward" else tuple(sorted(MAIN_PATH)))
    got, want = fused.compute(), jax_mc.compute()
    assert fused._fused_cmp_keys == tuple(sorted(MAIN_PATH))
    for k, m in single.items():
        _assert_same_states(fused[k], m)
        _assert_close(got[k], m.compute().numpy())
        _assert_close(got[k], want[k])
    assert not fused._fused_failed and not fused._fused_fwd_failed and not fused._fused_cmp_failed


def test_value_checks_skip_inside_the_engine_like_the_jitted_jax_update():
    """The JAX reference note: an out-of-range label raises in the eager
    update (``jit_update=False``) and passes the engine update, in both
    packages, with equal states."""
    preds, target = np.array([0, 1, 2]), np.array([0, 1, 9])
    for pkg, conv, kw in ((mj, jnp.asarray, {}), (mt, torch.from_numpy, {"device": "cpu"})):
        with pytest.raises(ValueError, match="outside the valid range"):
            pkg.Accuracy(num_classes=3, jit_update=False, **kw).update(conv(preds), conv(target))
    jax_m = mj.Accuracy(num_classes=3)
    port_m = mt.Accuracy(num_classes=3, device="cpu")
    jax_m.update(jnp.asarray(preds), jnp.asarray(target))
    port_m.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert not port_m._jit_failed
    _assert_states(port_m, jax_m)
    _assert_close(port_m.compute(), jax_m.compute())


def test_pure_update_state_leaves_the_callers_state_alone():
    p, t = _cls_batches(12, [16])[0]
    m = mt.Accuracy(num_classes=C, device="cpu")
    s1 = m.init_state()
    s2 = m.update_state(s1, *_port(p, t))
    s3 = m.update_state(s2, *_port(p, t))
    assert all(int(v.sum()) == 0 for v in s1.values())
    assert int(s3["tp"]) == 2 * int(s2["tp"])
    jax_m = mj.Accuracy(num_classes=C)
    jax_s = jax_m.update_state(jax_m.update_state(jax_m.init_state(), *_jax(p, t)), *_jax(p, t))
    _assert_close(m.compute_state(s3), jax_m.compute_state(jax_s))


def test_copies_drop_the_engine_key_and_keep_their_counters_apart():
    p, t = _cls_batches(13, [16])[0]
    m = mt.ConfusionMatrix(num_classes=C, device="cpu")
    m.update(*_port(p, t))
    assert "_engine_key" in m.__dict__
    twin = copy.deepcopy(m)
    assert "_engine_key" not in twin.__dict__ and twin.compile_stats()["compiles"] == 0
    twin.update(*_port(p, t))
    m.update(*_port(p, t))
    assert torch.equal(twin.confmat, m.confmat)
    assert twin.compile_stats()["cache_hits"] == 1

"""The port's numerical-health screening (``metrics_tpu_torch.resilience.health``)
against the JAX package's on the same numpy inputs, on the CPU: each policy's
states and ``health_report()`` counts, the ``"raise"`` message, the
aggregators' ``nan_strategy`` alias, the saturating stat-score sums and the
counters as state (forward merges, reset, clones, collections). It mirrors
``tests/resilience/test_health.py``.

Tolerances: counts and integer states bit for bit; float sums within 1e-5
relative (float64 x64 JAX lane against the port's float32 states).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mj
import metrics_tpu_torch as mt
from metrics_tpu import engine as ej
from metrics_tpu.ops.safe_ops import saturating_add as jax_saturating_add
from metrics_tpu.resilience import health as jh
from metrics_tpu.utils.exceptions import NumericalHealthError as JaxHealthError
from metrics_tpu_torch import engine as et
from metrics_tpu_torch.ops.safe_ops import saturating_add
from metrics_tpu_torch.resilience import health as th
from metrics_tpu_torch.utils.exceptions import NumericalHealthError

COUNTERS = ("nan_count", "inf_count", "rows_masked", "updates_quarantined", "overflow_events", "batches_screened")
PKGS = ((mj, jnp.asarray, {}), (mt, lambda a: torch.from_numpy(np.asarray(a)), {"device": "cpu"}))


@pytest.fixture(autouse=True)
def _fresh_caches():
    ej.clear_cache()
    et.clear_cache()
    yield
    ej.clear_cache()
    et.clear_cache()


def _nan_batch(rng, n=12, num_classes=3, bad_rows=(2, 5), bad_value=np.nan):
    preds = rng.rand(n, num_classes).astype(np.float32)
    target = (np.arange(n) % num_classes).astype(np.int64)
    for r in bad_rows:
        preds[r, r % num_classes] = bad_value
    return preds, target


def _value(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(port_v, jax_v, rtol=1e-5):
    p, j = _value(port_v), _value(jax_v)
    assert p.shape == j.shape
    if j.dtype.kind in "iub":
        np.testing.assert_array_equal(p, j)
    else:
        np.testing.assert_allclose(p, j, rtol=rtol, atol=0, equal_nan=True)


def _assert_states_and_reports(port_m, jax_m):
    assert set(port_m._defaults) == set(jax_m._defaults)
    for name in port_m._defaults:
        _assert_same(getattr(port_m, name), getattr(jax_m, name))
    port_r, jax_r = port_m.health_report(), jax_m.health_report()
    for key in COUNTERS + ("on_bad_input", "screen", "last_compute_nonfinite"):
        assert port_r[key] == jax_r[key], key


def _run_both(make, steps, fn="update"):
    """``make(pkg, **dev)`` in both packages, ``steps`` (tuples of numpy
    arrays or kwargs dicts) through ``fn``; returns (port, jax)."""
    out = []
    for pkg, conv, dev in PKGS:
        m = make(pkg, **dev)
        for step in steps:
            if isinstance(step, dict):
                getattr(m, fn)(**{k: conv(v) for k, v in step.items()})
            else:
                getattr(m, fn)(*map(conv, step))
        out.append(m)
    return out[1], out[0]


def test_invalid_policy_rejected_like_jax():
    with pytest.raises(ValueError) as jax_err:
        mj.Accuracy(on_bad_input="quarantine")
    with pytest.raises(ValueError) as port_err:
        mt.Accuracy(on_bad_input="quarantine", device="cpu")
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("policy", ["propagate", "skip"])
def test_the_counter_state_is_registered_only_under_a_policy(policy):
    port_m = mt.Accuracy(on_bad_input=policy, device="cpu")
    jax_m = mj.Accuracy(on_bad_input=policy)
    assert (th.HEALTH_STATE in port_m._defaults) == (jh.HEALTH_STATE in jax_m._defaults) == (policy != "propagate")
    if policy != "propagate":
        assert port_m._reductions[th.HEALTH_STATE] == "sum"
    assert port_m.health_report() == {**jax_m.health_report(), "batches_screened": 0}


@pytest.mark.parametrize("bad_value", [np.nan, np.inf, -np.inf], ids=["nan", "inf", "-inf"])
@pytest.mark.parametrize("path", ["update", "forward"])
def test_skip_quarantines_like_jax(bad_value, path):
    """``"skip"``: the contaminated update is dropped whole; the states equal
    the stream without it and the JAX states, and the counters agree."""
    rng = np.random.RandomState(0)
    clean1 = _nan_batch(rng, bad_rows=())
    bad = _nan_batch(rng, bad_rows=(1, 4), bad_value=bad_value)
    clean2 = _nan_batch(rng, bad_rows=())
    make = lambda pkg, **kw: pkg.Accuracy(num_classes=3, on_bad_input="skip", **kw)  # noqa: E731
    port_m, jax_m = _run_both(make, [clean1, bad, clean2], fn=path)
    _assert_states_and_reports(port_m, jax_m)
    witness = mt.Accuracy(num_classes=3, device="cpu")
    for p, t in (clean1, clean2):
        witness.update(torch.from_numpy(p), torch.from_numpy(t))
    for name in witness._defaults:
        assert torch.equal(getattr(port_m, name), getattr(witness, name))
    report = port_m.health_report()
    assert report["updates_quarantined"] == 1 and report["batches_screened"] == 3
    assert report["nan_count" if np.isnan(bad_value) else "inf_count"] == 2


def test_mask_drops_rows_exactly_like_jax():
    rng = np.random.RandomState(1)
    preds, target = rng.rand(16).astype(np.float32), rng.rand(16).astype(np.float32)
    preds_bad = preds.copy()
    preds_bad[[3, 9]] = np.nan
    make = lambda pkg, **kw: pkg.MeanSquaredError(on_bad_input="mask", **kw)  # noqa: E731
    port_m, jax_m = _run_both(make, [(preds_bad, target)])
    _assert_states_and_reports(port_m, jax_m)
    keep = np.ones(16, bool)
    keep[[3, 9]] = False
    witness = mt.MeanSquaredError(device="cpu")
    witness.update(torch.from_numpy(preds[keep]), torch.from_numpy(target[keep]))
    assert torch.equal(port_m.total, witness.total)
    torch.testing.assert_close(port_m.sum_squared_error, witness.sum_squared_error, rtol=1e-6, atol=0)
    assert port_m.health_report()["rows_masked"] == 2 and not port_m._jit_failed


@pytest.mark.parametrize(
    "case",
    ["mean_joint_pair", "max_non_additive_eager", "sum_scalar_quarantine", "sum_rank2_elements", "mean_rank2_elements"],
)
def test_aggregator_masking_matches_jax(case):
    make, steps = {
        "mean_joint_pair": (
            lambda pkg, **kw: pkg.MeanMetric(nan_strategy="ignore", **kw),
            [(np.array([1.0, np.nan, 3.0, 5.0], np.float32), np.array([1.0, 2.0, np.nan, 4.0], np.float32))],
        ),
        "max_non_additive_eager": (
            lambda pkg, **kw: pkg.MaxMetric(nan_strategy="error", on_bad_input="mask", **kw),
            [(np.array([1.0, np.nan, 5.0], np.float32),)],
        ),
        "sum_scalar_quarantine": (
            lambda pkg, **kw: pkg.SumMetric(nan_strategy="ignore", **kw),
            [(np.float32(2.0),), (np.float32(np.nan),), (np.float32(3.0),)],
        ),
        "sum_rank2_elements": (
            lambda pkg, **kw: pkg.SumMetric(nan_strategy="ignore", **kw),
            [(np.array([[1.0, np.nan], [2.0, 3.0]], np.float32),)],
        ),
        "mean_rank2_elements": (
            lambda pkg, **kw: pkg.MeanMetric(nan_strategy="ignore", **kw),
            [(np.array([[1.0, np.nan], [2.0, 3.0]], np.float32),)],
        ),
    }[case]
    port_m, jax_m = _run_both(make, steps)
    _assert_states_and_reports(port_m, jax_m)
    _assert_same(port_m.compute(), jax_m.compute())
    if case == "max_non_additive_eager":  # routed to the eager update, never a program
        assert port_m.compile_stats()["compiles"] == port_m.compile_stats()["cache_hits"] == 0
    else:
        assert not port_m._jit_failed


def test_raise_message_matches_jax_and_the_state_stays_clean():
    make = lambda pkg, **kw: pkg.MeanSquaredError(on_bad_input="raise", **kw)  # noqa: E731
    msgs = []
    for pkg, conv, dev in PKGS:
        m = make(pkg, **dev)
        m.update(conv(np.array([1.0, 2.0], np.float32)), conv(np.array([1.0, 1.0], np.float32)))
        err_type = JaxHealthError if pkg is mj else NumericalHealthError
        with pytest.raises(err_type, match=r"update #2.*1 NaN and 1 ±Inf") as err:
            m.update(conv(np.array([np.nan, np.inf], np.float32)), conv(np.array([1.0, 1.0], np.float32)))
        msgs.append(str(err.value))
        assert float(m.compute()) == 0.5
        m.update(conv(np.array([3.0], np.float32)), conv(np.array([1.0], np.float32)))  # no re-raise
        assert m.health_report()["updates_quarantined"] == 1
    assert msgs[0] == msgs[1]
    assert issubclass(NumericalHealthError, RuntimeError)


@pytest.mark.parametrize("case", ["forward_dance", "reset", "state_dict_load"])
def test_raise_check_holds_through_forward_reset_and_loads(case):
    """The per-update sentinel keeps the "raise" check right after a forward
    dance, a ``reset()`` and a ``load_state_dict``."""
    bad, one = torch.tensor([np.nan]), torch.tensor([1.0])
    m = mt.MeanSquaredError(on_bad_input="raise", device="cpu")
    with pytest.raises(NumericalHealthError):
        m.update(bad, one)
    if case == "forward_dance":
        m(torch.tensor([1.0, 2.0]), torch.tensor([1.0, 2.0]))
        m.update(torch.tensor([3.0]), torch.tensor([3.0]))
    elif case == "reset":
        m.reset()
    else:
        m.persistent(True)
        fresh = mt.MeanSquaredError(on_bad_input="raise", device="cpu")
        fresh.persistent(True)
        fresh.load_state_dict(m.state_dict())
        m = fresh
        m.update(one, one)  # restored counters sit above a fresh mirror: no spurious raise
    with pytest.raises(NumericalHealthError):
        m.update(torch.tensor([np.inf]), one)


def test_collection_raise_members_all_check_before_the_error():
    make = lambda pkg, **kw: pkg.MetricCollection(  # noqa: E731
        {"a": pkg.Accuracy(num_classes=3, on_bad_input="raise", **kw), "b": pkg.Accuracy(num_classes=3, top_k=2, on_bad_input="raise", **kw)}
    )
    rng = np.random.RandomState(8)
    p, t = _nan_batch(rng, bad_rows=(1,))
    clean = _nan_batch(rng, bad_rows=())
    reports = []
    for pkg, conv, dev in PKGS:
        mc = make(pkg, **dev)
        with pytest.raises(RuntimeError):
            mc.update(conv(p), conv(t))
        mc.update(*map(conv, clean))
        reports.append(mc.health_report())
        assert mc._fused_keys == ("a", "b")
    assert reports[0]["updates_quarantined"] == reports[1]["updates_quarantined"] == 2


def test_one_eager_policy_member_does_not_break_collection_fusion():
    rng = np.random.RandomState(9)
    p, t = rng.rand(8, 3).astype(np.float32), np.arange(8) % 3
    for pkg, conv, dev in PKGS:
        mc = pkg.MetricCollection(
            {
                "mx": pkg.MaxMetric(nan_strategy="error", on_bad_input="mask", **dev),
                "acc": pkg.Accuracy(num_classes=3, **dev),
                "acc2": pkg.Accuracy(num_classes=3, top_k=2, **dev),
            }
        )
        mc.update(preds=conv(p), target=conv(t), value=conv(np.array([1.0, 2.0], np.float32)))
        assert not mc._fused_failed and set(mc._fused_keys) == {"acc", "acc2"}


@pytest.mark.parametrize("bucket", [None, "pow2"])
def test_aggregator_masking_is_immune_to_jit_bucket(bucket):
    """The flatten prescreen redefines what a row is, so bucketing stays off
    for a screened aggregator: the same value with and without it."""
    make = lambda pkg, **kw: pkg.SumMetric(nan_strategy="ignore", jit_bucket=bucket, **kw)  # noqa: E731
    port_m, jax_m = _run_both(make, [(np.array([[1.0, np.nan], [3.0, 4.0]], np.float32),)])
    assert float(port_m.compute()) == float(jax_m.compute()) == 8.0
    assert port_m.compile_stats()["bucketed_calls"] == 0


def test_warn_strategy_warns_at_removal_and_never_rides_a_mask_program():
    a = mt.SumMetric(on_bad_input="mask", device="cpu")
    a.update(torch.tensor([1.0, 2.0, 3.0]))
    with pytest.warns(UserWarning, match="Will be removed"):
        b = mt.SumMetric(device="cpu")  # the default "warn"
        b.update(torch.tensor([1.0, np.nan, 3.0]))
    assert float(b.compute()) == 4.0 and b.compile_stats()["cache_hits"] == 0
    with pytest.warns(UserWarning, match="Will be removed"):
        mx = mt.MaxMetric(device="cpu")
        mx.update(torch.tensor([1.0, np.nan, 5.0]))
    assert float(mx.compute()) == 5.0


@pytest.mark.parametrize(
    "case", ["mean_zero_weight_nan_result", "max_inf_is_data", "sum_inf_is_data", "empty_stream_max"]
)
def test_compute_result_checks_like_jax(case):
    if case == "mean_zero_weight_nan_result":
        for pkg, conv, dev in PKGS:
            m = pkg.MeanMetric(nan_strategy="error", **dev)
            m.update(conv(np.array([1.0, 1.0], np.float32)), weight=conv(np.array([1.0, -1.0], np.float32)))
            with pytest.raises(RuntimeError, match="non-finite"):
                m.compute()
    elif case == "empty_stream_max":
        with pytest.warns(UserWarning, match="before the ``update``"):
            assert np.isneginf(float(mt.MaxMetric(nan_strategy="error", device="cpu").compute()))
    else:
        cls = "MaxMetric" if case == "max_inf_is_data" else "SumMetric"
        strategy = "error" if cls == "MaxMetric" else "ignore"
        make = lambda pkg, **kw: getattr(pkg, cls)(nan_strategy=strategy, **kw)  # noqa: E731
        port_m, jax_m = _run_both(make, [(np.array([1.0, np.inf], np.float32),)])
        assert np.isposinf(float(port_m.compute())) and np.isposinf(float(jax_m.compute()))
        _assert_states_and_reports(port_m, jax_m)


@pytest.mark.parametrize("policy", ["skip", "mask"])
def test_policies_are_deterministic_and_add_no_program(policy):
    def run(pol):
        et.clear_cache()
        rng = np.random.RandomState(3)
        m = mt.MeanSquaredError(on_bad_input=pol, device="cpu")
        for i in range(5):
            p = rng.rand(8).astype(np.float32)
            if i % 2:
                p[rng.randint(8)] = np.inf
            m.update(torch.from_numpy(p), torch.from_numpy(rng.rand(8).astype(np.float32)))
        rep = m.health_report()
        return float(m.compute()), rep["rows_masked"], rep["updates_quarantined"], rep["inf_count"], m.compile_stats()["compiles"]

    first, second = run(policy), run(policy)
    assert first == second
    assert first[-1] == run("propagate")[-1] == 1


def test_saturating_add_matches_jax():
    acc = np.array([2**31 - 3, 5], np.int32)
    inc = np.array([10, 1], np.int32)
    out, overflowed = saturating_add(torch.from_numpy(acc), torch.from_numpy(inc))
    jax_out, jax_overflowed = jax_saturating_add(jnp.asarray(acc), jnp.asarray(inc))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jax_out))
    assert bool(overflowed) == bool(jax_overflowed) is True
    out2, ov2 = saturating_add(out, torch.tensor([0, 1], dtype=torch.int32))
    assert not bool(ov2) and int(out2[0]) == 2**31 - 1 and int(out2[1]) == 7


def test_stat_scores_saturate_and_count_the_overflow():
    p = np.random.RandomState(0).rand(6, 3).astype(np.float32)
    t = np.arange(6) % 3
    for pkg, conv, dev in PKGS:
        m = pkg.Accuracy(num_classes=3, on_bad_input="skip", **dev)
        m.update(conv(p), conv(t))
        top = np.iinfo(np.int64).max
        m.tn = conv(np.array(top - 1, np.int64))
        m.update(conv(p), conv(t))
        assert int(_value(m.tn)) == top
        assert m.health_report()["overflow_events"] == 1


def test_collection_reports_fused_equal_unfused_and_clones_carry_counters():
    make = lambda pkg, **kw: pkg.MetricCollection(  # noqa: E731
        {"acc": pkg.Accuracy(num_classes=3, on_bad_input="skip", **kw), "top1": pkg.Accuracy(num_classes=3, on_bad_input="skip", top_k=1, **kw)}
    )
    rng = np.random.RandomState(2)
    batches = [_nan_batch(rng, bad_rows=()), _nan_batch(rng, bad_rows=(0,)), _nan_batch(rng, bad_rows=())]
    fused, unfused = make(mt, device="cpu"), make(mt, device="cpu")
    unfused._fused_failed = True
    jax_mc = make(mj)
    for p, t in batches:
        fused.update(torch.from_numpy(p), torch.from_numpy(t))
        unfused.update(torch.from_numpy(p), torch.from_numpy(t))
        jax_mc.update(jnp.asarray(p), jnp.asarray(t))
    fr, ur, jr = fused.health_report(), unfused.health_report(), jax_mc.health_report()
    for key in ("nan_count", "updates_quarantined", "rows_masked", "batches_screened", "any_compute_nonfinite"):
        assert fr[key] == ur[key] == jr[key], key
    assert fr["updates_quarantined"] == 2 and set(fr["members"]) == {"acc", "top1"}
    clone = fused.clone()
    for p, t in batches:
        clone.update(torch.from_numpy(p), torch.from_numpy(t))
    assert clone.health_report()["updates_quarantined"] == 4
    assert fused.health_report()["updates_quarantined"] == 2


def test_forward_merges_counts_and_reset_clears_them():
    rng = np.random.RandomState(4)
    p, t = _nan_batch(rng, bad_rows=(1,))
    make = lambda pkg, **kw: pkg.Accuracy(num_classes=3, on_bad_input="skip", **kw)  # noqa: E731
    port_m, jax_m = _run_both(make, [(p, t)], fn="forward")
    _assert_states_and_reports(port_m, jax_m)
    assert port_m.health_report()["updates_quarantined"] == 1
    port_m.reset()
    rep = port_m.health_report()
    assert rep["updates_quarantined"] == 0 and rep["batches_screened"] == 1


def test_counters_ride_the_state_dict():
    rng = np.random.RandomState(6)
    m = mt.Accuracy(num_classes=3, on_bad_input="skip", device="cpu")
    for bad in ((), (2,), ()):
        p, t = _nan_batch(rng, bad_rows=bad)
        m.update(torch.from_numpy(p), torch.from_numpy(t))
    m.persistent(True)
    fresh = mt.Accuracy(num_classes=3, on_bad_input="skip", device="cpu")
    fresh.persistent(True)
    fresh.load_state_dict(m.state_dict())
    assert torch.equal(getattr(fresh, th.HEALTH_STATE), getattr(m, th.HEALTH_STATE))
    old = mt.MeanSquaredError(device="cpu")
    old.update(torch.tensor([1.0, 3.0]), torch.tensor([1.0, 1.0]))
    old.persistent(True)
    screened = mt.MeanSquaredError(on_bad_input="skip", device="cpu")
    screened.persistent(True)
    result = screened.load_state_dict(old.state_dict())  # from before the policy: counters stay zero
    assert not result.missing_keys and screened.health_report()["updates_quarantined"] == 0
    assert float(screened.compute()) == float(old.compute())

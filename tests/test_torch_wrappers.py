"""The port's wrappers (``metrics_tpu_torch/wrappers``) against
``metrics_tpu``'s on the same numpy streams.

``BootStrapper`` draws its resampling indices from the same host sampler
(``numpy.random.default_rng(seed)``, the same draws in the same order), so
the two packages' replicates are the same resamples and are compared one by
one, on the multinomial fast path (one program for all replicates) and on
the eager clones (poisson, and multinomial with the program disabled).

Tolerances: counts and integer-valued results exactly; float scores within
1e-6 relative and 1e-6 absolute; float32 sums (the regression members)
within 1e-5 relative.
"""
import copy
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mj
import metrics_tpu_torch as mt
from metrics_tpu_torch.utils.checks import _allclose_recursive

C = 5
RTOL, ATOL = 1e-6, 1e-6
SUM_RTOL = 1e-5


def _logits(seed: int, sizes=(40, 40, 23)):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((n, C)).astype(np.float32), rng.integers(0, C, n)) for n in sizes]


def _regression(seed: int, sizes=(40, 40, 23)):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        target = rng.standard_normal(n).astype(np.float32)
        out.append(((target + 0.5 * rng.standard_normal(n)).astype(np.float32), target))
    return out


def _t(batch):
    return tuple(torch.from_numpy(x) for x in batch)


def _j(batch):
    return tuple(jnp.asarray(x) for x in batch)


def _assert_close(got, want, rtol: float = RTOL) -> None:
    """Trees of tensors: integers exactly, floats within ``rtol`` and ATOL."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_close(got[k], want[k], rtol)
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_close(g, w, rtol)
        return
    g, w = torch.as_tensor(got).detach().cpu().numpy(), np.asarray(want)
    assert g.shape == w.shape
    if w.dtype.kind in "iub":
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=ATOL)


# ---------------------------------------------------------------------------
# BootStrapper
# ---------------------------------------------------------------------------
# id -> (factory(package, **device kwargs), batches, float32 sums)
BASES = {
    "accuracy_top2": (lambda p, **d: p.Accuracy(num_classes=C, top_k=2, **d), _logits(1), False),
    "mcc": (lambda p, **d: p.MatthewsCorrCoef(num_classes=C, **d), _logits(2), False),
    "confmat_f1": (lambda p, **d: p.F1Score(num_classes=C, average="macro", **d), _logits(3), False),
    "mse": (lambda p, **d: p.MeanSquaredError(**d), _regression(4), True),
}


def _boot_pair(base: str, strategy: str, **kwargs):
    factory, batches, sums = BASES[base]
    kw = dict(num_bootstraps=7, sampling_strategy=strategy, quantile=[0.025, 0.5, 0.975], raw=True, seed=11, **kwargs)
    return mt.BootStrapper(factory(mt, device="cpu"), **kw), mj.BootStrapper(factory(mj), **kw), batches, sums


@pytest.mark.parametrize("strategy", ["multinomial", "poisson"])
@pytest.mark.parametrize("base", sorted(BASES))
def test_bootstrap_replicates_equal_jax_one_by_one(base, strategy):
    port_b, jax_b, batches, sums = _boot_pair(base, strategy)
    for batch in batches:
        port_b.update(*_t(batch))
        jax_b.update(*_j(batch))
    assert port_b._use_fast_path == jax_b._use_fast_path == (strategy == "multinomial")
    _assert_close(port_b.compute(), jax_b.compute(), SUM_RTOL if sums else RTOL)


@pytest.mark.parametrize("base", sorted(BASES))
def test_bootstrap_fast_path_is_one_shared_program_per_input_signature(base):
    from metrics_tpu_torch.engine import cache

    cache.clear_cache()  # the programs are shared with earlier instances of the same configuration
    port_b, jax_b, batches, _ = _boot_pair(base, "multinomial")
    for batch in batches:
        port_b.update(*_t(batch))
    stats = port_b.compile_stats()["children"]["template"]
    # two signatures (40 rows, 23 rows): two programs, the second 40-row batch a cache hit
    assert (stats["compiles"], stats["cache_hits"], stats["jit_failed"]) == (2, 1, False)
    assert cache.cache_summary()["by_kind"]["bootstrap_update"]["entries"] == 1
    # a second bootstrapper of the same configuration runs the same programs
    twin, _, _, _ = _boot_pair(base, "multinomial")
    for batch in batches:
        twin.update(*_t(batch))
    assert twin.compile_stats()["children"]["template"]["cache_hits"] == 3
    assert all(port_b.compile_stats()["children"][f"bootstrap_{i}"]["compiles"] == 0 for i in range(7))


@pytest.mark.parametrize("base", ["accuracy_top2", "mse"])
def test_bootstrap_multinomial_eager_clones_equal_jax(base):
    """A template that runs eagerly (``jit_update=False``) keeps the clones,
    in both packages, with the same draws."""
    factory, batches, sums = BASES[base]
    kw = dict(num_bootstraps=5, sampling_strategy="multinomial", raw=True, seed=5)
    port_b = mt.BootStrapper(factory(mt, device="cpu", jit_update=False), **kw)
    jax_b = mj.BootStrapper(factory(mj, jit_update=False), **kw)
    for batch in batches:
        port_b.update(*_t(batch))
        jax_b.update(*_j(batch))
    assert port_b._use_fast_path is False and jax_b._use_fast_path is False
    _assert_close(port_b.compute(), jax_b.compute(), SUM_RTOL if sums else RTOL)


@pytest.mark.parametrize("strategy", ["multinomial", "poisson"])
def test_bootstrap_reset_reseeds(strategy):
    port_b, jax_b, batches, _ = _boot_pair("accuracy_top2", strategy)
    first = []
    for batch in batches:
        port_b.update(*_t(batch))
    first = port_b.compute()["raw"].clone()
    port_b.reset()
    jax_b.reset()
    for batch in batches:
        port_b.update(*_t(batch))
        jax_b.update(*_j(batch))
    assert torch.equal(port_b.compute()["raw"], first)
    _assert_close(port_b.compute(), jax_b.compute())


@pytest.mark.parametrize("strategy", ["multinomial", "poisson"])
def test_bootstrap_forward_gives_the_running_statistics_like_jax(strategy):
    port_b, jax_b, batches, _ = _boot_pair("mcc", strategy)
    for batch in batches:
        _assert_close(port_b(*_t(batch)), jax_b(*_j(batch)))


# ---------------------------------------------------------------------------
# MinMaxMetric, ClasswiseWrapper, MultioutputWrapper
# ---------------------------------------------------------------------------
def test_minmax_compute_and_forward_follow_jax():
    batches = _logits(7, sizes=(30, 31, 32, 9))
    for forward in (False, True):
        port_m = mt.MinMaxMetric(mt.Accuracy(num_classes=C, device="cpu"))
        jax_m = mj.MinMaxMetric(mj.Accuracy(num_classes=C))
        for batch in batches:
            if forward:
                # the batch-local value folds into the trackers
                _assert_close(port_m(*_t(batch)), jax_m(*_j(batch)))
            else:
                port_m.update(*_t(batch))
                jax_m.update(*_j(batch))
                _assert_close(port_m.compute(), jax_m.compute())
        _assert_close(port_m.compute(), jax_m.compute())
        assert port_m.min_val.device.type == "cpu"


def test_minmax_trackers_are_not_states_and_survive_sync_and_reset():
    port_m = mt.MinMaxMetric(mt.MeanMetric(device="cpu"))
    assert port_m._defaults == {}
    for v in (2.0, 6.0):
        port_m.update(torch.tensor([v]))
        port_m.compute()
    port_m.sync(dist_sync_fn=lambda t, group=None: [t], distributed_available=lambda: True)
    assert port_m._is_synced
    port_m.unsync()
    assert (float(port_m.min_val), float(port_m.max_val)) == (2.0, 4.0)
    port_m.reset()
    assert (float(port_m.min_val), float(port_m.max_val)) == (float("inf"), float("-inf"))


def test_minmax_rejects_a_non_scalar_value():
    port_m = mt.MinMaxMetric(mt.Recall(num_classes=C, average=None, device="cpu"))
    port_m.update(*_t(_logits(8)[0]))
    with pytest.raises(RuntimeError, match="should be a scalar"):
        port_m.compute()


@pytest.mark.parametrize("labels", [None, ["a", "b", "c", "d", "e"]])
def test_classwise_keys_and_values_follow_jax(labels):
    port_m = mt.ClasswiseWrapper(mt.Recall(num_classes=C, average=None, device="cpu"), labels=labels)
    jax_m = mj.ClasswiseWrapper(mj.Recall(num_classes=C, average=None), labels=labels)
    for batch in _logits(9):
        _assert_close(port_m(*_t(batch)), jax_m(*_j(batch)))
    got = port_m.compute()
    assert list(got) == [f"recall_{lab}" for lab in (labels or range(C))]
    _assert_close(got, jax_m.compute())


def _multioutput_batches(seed: int, nan_rows: bool):
    rng = np.random.default_rng(seed)
    out = []
    for n in (50, 50, 17):
        target = rng.standard_normal((n, 3)).astype(np.float32)
        preds = (target + 0.3 * rng.standard_normal((n, 3))).astype(np.float32)
        if nan_rows:
            preds[rng.choice(n, 4, replace=False), rng.integers(0, 3, 4)] = np.nan
            target[rng.choice(n, 2, replace=False), 1] = np.nan
        out.append((preds, target))
    return out


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("base", ["mae", "r2"])
def test_multioutput_drops_nan_rows_per_output_like_jax(base, forward):
    make = {"mae": lambda p, **d: p.MeanAbsoluteError(**d), "r2": lambda p, **d: p.R2Score(**d)}[base]
    port_m = mt.MultioutputWrapper(make(mt, device="cpu"), num_outputs=3)
    jax_m = mj.MultioutputWrapper(make(mj), num_outputs=3)
    for batch in _multioutput_batches(10, nan_rows=True):
        if forward:
            _assert_close(port_m(*_t(batch)), jax_m(*_j(batch)), SUM_RTOL)
        else:
            port_m.update(*_t(batch))
            jax_m.update(*_j(batch))
    _assert_close(port_m.compute(), jax_m.compute(), SUM_RTOL)
    assert all(not m._enable_jit for m in port_m.metrics)


def test_multioutput_without_nan_removal_along_dim_0_follows_jax():
    rng = np.random.default_rng(12)
    port_m = mt.MultioutputWrapper(
        mt.MeanSquaredError(device="cpu"), num_outputs=2, output_dim=0, remove_nans=False, squeeze_outputs=True
    )
    jax_m = mj.MultioutputWrapper(mj.MeanSquaredError(), num_outputs=2, output_dim=0, remove_nans=False)
    for n in (20, 7):
        batch = (rng.standard_normal((2, n)).astype(np.float32), rng.standard_normal((2, n)).astype(np.float32))
        _assert_close(port_m(*_t(batch)), jax_m(*_j(batch)), SUM_RTOL)
    _assert_close(port_m.compute(), jax_m.compute(), SUM_RTOL)
    # without NaN removal the clones keep their programs
    assert all(m._enable_jit for m in port_m.metrics)


# ---------------------------------------------------------------------------
# MetricTracker
# ---------------------------------------------------------------------------
def _tracker_collection(p, **d):
    return p.MetricCollection(
        {
            "acc": p.Accuracy(num_classes=C, **d),
            "f1": p.F1Score(num_classes=C, average="macro", **d),
            "confmat": p.ConfusionMatrix(num_classes=C, **d),
        }
    )


def test_tracker_over_a_collection_with_a_maximize_list_follows_jax():
    port_t = mt.MetricTracker(_tracker_collection(mt, device="cpu"), maximize=[True, False, True])
    jax_t = mj.MetricTracker(_tracker_collection(mj), maximize=[True, False, True])
    for epoch in range(3):
        port_t.increment()
        jax_t.increment()
        for batch in _logits(20 + epoch):
            _assert_close(port_t(*_t(batch)), jax_t(*_j(batch)))
    assert port_t.n_steps == len(port_t) == 3
    port_all, jax_all = port_t.compute_all(), jax_t.compute_all()
    _assert_close(port_all, jax_all)
    idx, best = port_t.best_metric(return_step=True)
    jidx, jbest = jax_t.best_metric(return_step=True)
    assert idx == jidx and sorted(best) == ["acc", "f1"]
    _assert_close(best, jbest)
    # the confusion matrix stacks too, but is not a scalar: no best value
    assert port_all["confmat"].shape == (3, C, C)


@pytest.mark.parametrize("maximize", [True, False])
def test_tracker_of_one_metric_follows_jax(maximize):
    port_t = mt.MetricTracker(mt.MeanSquaredError(device="cpu"), maximize=maximize)
    jax_t = mj.MetricTracker(mj.MeanSquaredError(), maximize=maximize)
    with pytest.raises(ValueError, match="increment"):
        port_t.update(*_t(_regression(0)[0]))
    for epoch in range(4):
        port_t.increment()
        jax_t.increment()
        for batch in _regression(30 + epoch):
            port_t.update(*_t(batch))
            jax_t.update(*_j(batch))
    _assert_close(port_t.compute_all(), jax_t.compute_all(), SUM_RTOL)
    idx, best = port_t.best_metric(return_step=True)
    jidx, jbest = jax_t.best_metric(return_step=True)
    assert idx == jidx
    assert best == pytest.approx(jbest, rel=SUM_RTOL)
    assert sorted(port_t.compile_stats()["steps"]) == [f"step_{i}" for i in range(4)]
    assert port_t.health_report()["steps"]["step_3"]["on_bad_input"] == "propagate"


def test_tracker_keeps_non_scalar_members_as_per_step_lists():
    port_t = mt.MetricTracker(mt.MetricCollection({"roc": mt.ROC(device="cpu"), "mse": mt.MeanSquaredError(device="cpu")}))
    rng = np.random.default_rng(3)
    for n in (12, 17):
        port_t.increment()
        port_t.update(torch.from_numpy(rng.random(n).astype(np.float32)), torch.from_numpy(rng.integers(0, 2, n)))
    out = port_t.compute_all()
    assert isinstance(out["roc"], list) and len(out["roc"]) == 2
    assert out["mse"].shape == (2,)
    assert sorted(port_t.best_metric()) == ["mse"]


def test_tracker_rejects_bad_maximize_arguments():
    with pytest.raises(ValueError, match="requires a MetricCollection"):
        mt.MetricTracker(mt.MeanSquaredError(device="cpu"), maximize=[True])
    with pytest.raises(ValueError, match="must match"):
        mt.MetricTracker(_tracker_collection(mt, device="cpu"), maximize=[True])
    with pytest.raises(TypeError):
        mt.MetricTracker(object())


# ---------------------------------------------------------------------------
# reports, copies
# ---------------------------------------------------------------------------
def _wrappers(p, **d):
    return {
        "bootstrap": p.BootStrapper(p.Accuracy(num_classes=C, **d), num_bootstraps=3, sampling_strategy="multinomial"),
        "minmax": p.MinMaxMetric(p.Accuracy(num_classes=C, **d)),
        "classwise": p.ClasswiseWrapper(p.Recall(num_classes=C, average=None, **d)),
        "multioutput": p.MultioutputWrapper(p.MeanAbsoluteError(**d), num_outputs=C),
    }


CHILDREN = {
    "bootstrap": ["bootstrap_0", "bootstrap_1", "bootstrap_2", "template"],
    "minmax": ["base"],
    "classwise": ["base"],
    "multioutput": [f"output_{i}" for i in range(C)],
}


def _wrapper_batch(name: str, seed: int):
    preds, target = _logits(seed, sizes=(24,))[0]
    if name == "multioutput":
        return preds, (preds + 0.1).astype(np.float32)
    return preds, target


@pytest.mark.parametrize("name", sorted(CHILDREN))
def test_reports_nest_the_inner_metrics_under_children_like_jax(name):
    port_m, jax_m = _wrappers(mt, device="cpu")[name], _wrappers(mj)[name]
    batch = _wrapper_batch(name, 40)
    port_m.update(*_t(batch))
    jax_m.update(*_j(batch))
    for report in ("compile_stats", "health_report"):
        got, want = getattr(port_m, report)(), getattr(jax_m, report)()
        assert sorted(got["children"]) == sorted(want["children"]) == CHILDREN[name]
        inner = getattr(port_m._children()[CHILDREN[name][0]], report)()
        assert got["children"][CHILDREN[name][0]] == inner
    assert "children" not in mt.Accuracy(num_classes=C, device="cpu").compile_stats()
    assert "children" not in mt.Accuracy(num_classes=C, device="cpu").health_report()


def test_a_collection_health_report_passes_a_wrappers_children_through():
    mc = mt.MetricCollection({"mm": mt.MinMaxMetric(mt.Accuracy(num_classes=C, device="cpu")), "acc": mt.Accuracy(num_classes=C, device="cpu")})
    mc.update(*_t(_logits(41, sizes=(16,))[0]))
    report = mc.health_report()
    assert report["nan_count"] == 0
    assert "children" in report["members"]["mm"] and "children" not in report


COPIES = {"clone": lambda m: m.clone(), "deepcopy": copy.deepcopy, "pickle": lambda m: pickle.loads(pickle.dumps(m))}


@pytest.mark.parametrize("how", sorted(COPIES))
@pytest.mark.parametrize("name", sorted(CHILDREN))
def test_a_wrapper_copied_mid_stream_carries_on_like_jax(name, how):
    port_m, jax_m = _wrappers(mt, device="cpu")[name], _wrappers(mj)[name]
    batches = [_wrapper_batch(name, 50 + i) for i in range(3)]
    port_m.update(*_t(batches[0]))
    jax_m.update(*_j(batches[0]))
    before = port_m.compute()
    jax_m.compute()
    port_c = COPIES[how](port_m)
    for batch in batches[1:]:
        port_c.update(*_t(batch))
        jax_m.update(*_j(batch))
    _assert_close(port_c.compute(), jax_m.compute(), SUM_RTOL)
    # the copy's updates left the original alone
    _assert_close(port_m.compute(), before, 0.0)


def test_wrappers_take_the_base_metrics_device_and_reject_non_metrics():
    for m in _wrappers(mt, device="cpu").values():
        assert m.device.type == "cpu"
    with pytest.raises(ValueError, match="instance of"):
        mt.BootStrapper(object())
    with pytest.raises(ValueError, match="sampling_strategy"):
        mt.BootStrapper(mt.Accuracy(num_classes=C, device="cpu"), sampling_strategy="gaussian")
    with pytest.raises(ValueError, match="instance of"):
        mt.MinMaxMetric(object())
    with pytest.raises(ValueError, match="labels"):
        mt.ClasswiseWrapper(mt.Recall(num_classes=C, average=None, device="cpu"), labels=[1, 2])


def test_allclose_recursive_follows_jax():
    from metrics_tpu.utils.checks import _allclose_recursive as jax_allclose

    a = {"x": np.arange(3.0), "y": [np.float32(1.0), "s"], "z": (np.ones(2), 3)}
    b = {"x": np.arange(3.0) + 1e-9, "y": [np.float32(1.0), "s"], "z": (np.ones(2), 3)}
    c = {"x": np.arange(3.0) + 1e-3, "y": [np.float32(1.0), "t"], "z": (np.ones(2), 4)}
    for got, want in ((a, b), (a, c)):
        ported = _allclose_recursive(
            {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in got.items()}, want
        )
        assert ported == jax_allclose(got, want)


@pytest.mark.parametrize("multilabel", [False, True])
def test_one_hot_input_format_follows_jax(multilabel):
    from metrics_tpu.utils.checks import _input_format_classification_one_hot as jax_one_hot
    from metrics_tpu_torch.utils.checks import _input_format_classification_one_hot as port_one_hot

    rng = np.random.default_rng(13)
    cases = [
        (rng.standard_normal((9, C)).astype(np.float32), rng.integers(0, C, 9)),  # scores: argmax, one-hot
        (rng.integers(0, C, 9), rng.integers(0, C, 9)),  # labels: one-hot
        (rng.random((9, C)).astype(np.float32), rng.integers(0, 2, (9, C))),  # multilabel probabilities: threshold
    ]
    for preds, target in cases[2:] if multilabel else cases:
        got = port_one_hot(C, torch.from_numpy(preds), torch.from_numpy(target), multilabel=multilabel)
        want = jax_one_hot(C, jnp.asarray(preds), jnp.asarray(target), multilabel=multilabel)
        _assert_close(got, want)

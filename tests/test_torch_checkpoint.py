"""The port's state helpers against ``metrics_tpu``'s: ``Metric.bind_state``
and ``utils/checkpoint.py``.

A tree written by ``metrics_tpu``'s ``metric_state_pytree`` restores into the
port's metric and computes the same value, and a tree of the port's restores
into ``metrics_tpu``'s: a curve metric with learned attributes (``_dynamic``),
list-state metrics and health-screened metrics. A restore or bind that fails
leaves the metric as it was. ``save_metric_state`` writes a file that
``torch.load(..., weights_only=True)`` reads.

Tolerances: counts exactly; float values within 1e-6 relative and absolute.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mj
import metrics_tpu.utils.checkpoint as cj
import metrics_tpu_torch as mt
import metrics_tpu_torch.utils.checkpoint as ct
from metrics_tpu_torch.utils.exceptions import MetricsUserError

C = 4
RTOL, ATOL = 1e-6, 1e-6


def _batches(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for n in (30, 21):
        if kind == "logits":
            out.append((rng.standard_normal((n, C)).astype(np.float32), rng.integers(0, C, n)))
        elif kind == "binary":
            out.append((rng.random(n).astype(np.float32), rng.integers(0, 2, n)))
        elif kind == "nan_values":
            x = rng.standard_normal(n).astype(np.float32)
            x[rng.choice(n, 3, replace=False)] = np.nan
            out.append((x,))
        else:  # regression
            t = rng.standard_normal(n).astype(np.float32)
            out.append(((t + 0.4 * rng.standard_normal(n)).astype(np.float32), t))
    return out


# id -> (input kind, factory(package, **device kwargs))
CASES = {
    # a curve metric whose update learns attributes (``_dynamic``) and buffers samples
    "ROC": ("binary", lambda p, **d: p.ROC(**d)),
    "Accuracy": ("logits", lambda p, **d: p.Accuracy(num_classes=C, **d)),
    "SpearmanCorrCoef": ("regression", lambda p, **d: p.SpearmanCorrCoef(**d)),
    "ConfusionMatrix": ("logits", lambda p, **d: p.ConfusionMatrix(num_classes=C, **d)),
    "MeanMetric_skip": ("nan_values", lambda p, **d: p.MeanMetric(nan_strategy="ignore", on_bad_input="skip", **d)),
    "F1Score_mask": ("logits", lambda p, **d: p.F1Score(num_classes=C, average="macro", on_bad_input="mask", **d)),
}


def _assert_close(got, want) -> None:
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_close(g, w)
        return
    g, w = torch.as_tensor(got).detach().cpu().numpy(), np.asarray(want)
    assert g.shape == w.shape
    if w.dtype.kind in "iu":
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def _fed(case: str):
    kind, factory = CASES[case]
    port_m, jax_m = factory(mt, device="cpu"), factory(mj)
    for batch in _batches(kind, seed=len(case)):
        port_m.update(*map(torch.from_numpy, batch))
        jax_m.update(*map(jnp.asarray, batch))
    return port_m, jax_m


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_jax_tree_restores_into_the_port(case):
    _, jax_m = _fed(case)
    tree = cj.metric_state_pytree(jax_m)
    fresh = CASES[case][1](mt, device="cpu")
    ct.restore_metric_state_pytree(fresh, tree)
    assert fresh._update_count == jax_m._update_count
    _assert_close(fresh.compute(), jax_m.compute())
    for attr in fresh._dynamic_state_attrs:
        assert getattr(fresh, attr) == getattr(jax_m, attr)
    if "_health_counts" in fresh._defaults:
        assert {k: v for k, v in fresh.health_report().items() if k != "last_compute_nonfinite"} == {
            k: v for k, v in jax_m.health_report().items() if k in fresh.health_report() and k != "last_compute_nonfinite"
        }


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_port_tree_restores_into_jax(case):
    port_m, jax_twin = _fed(case)
    tree = ct.metric_state_pytree(port_m)
    assert all(isinstance(v, (np.ndarray, dict, int, bool)) for v in tree.values())
    assert sorted(tree) == sorted(cj.metric_state_pytree(jax_twin))
    fresh = CASES[case][1](mj)
    cj.restore_metric_state_pytree(fresh, tree)
    _assert_close(port_m.compute(), fresh.compute())


def test_a_restored_tree_carries_on_like_the_uninterrupted_stream():
    port_m, jax_m = _fed("ROC")
    fresh = mt.ROC(device="cpu")
    ct.restore_metric_state_pytree(fresh, cj.metric_state_pytree(jax_m))
    more = _batches("binary", 99)
    for batch in more:
        fresh.update(*map(torch.from_numpy, batch))
        jax_m.update(*map(jnp.asarray, batch))
    _assert_close(fresh.compute(), jax_m.compute())


def _states(m):
    return {n: (list(v) if isinstance(v, list) else v.clone()) for n, v in m._snapshot_state().items()}


def _unchanged(m, before, count) -> None:
    assert m._update_count == count
    after = m._snapshot_state()
    for n, v in before.items():
        if isinstance(v, list):
            assert len(after[n]) == len(v) and all(torch.equal(a, b) for a, b in zip(after[n], v))
        else:
            assert torch.equal(after[n], v)


def _corrupt(tree, how):
    tree = dict(tree)
    if how == "missing_update_count":
        del tree["_update_count"]
    elif how == "missing_state":
        del tree["confmat"]
    elif how == "other_num_classes":
        tree["confmat"] = np.zeros((C + 1, C + 1), dtype=np.int64)
    elif how == "float_for_int":
        tree["confmat"] = tree["confmat"].astype(np.float32)
    elif how == "list_for_array":
        tree["confmat"] = {"0": tree["confmat"]}
    return tree


@pytest.mark.parametrize(
    "how,error",
    [
        ("missing_update_count", KeyError),
        ("missing_state", KeyError),
        ("other_num_classes", ValueError),
        ("float_for_int", ValueError),
        ("list_for_array", ValueError),
    ],
)
def test_a_failed_restore_leaves_the_metric_untouched_like_jax(how, error):
    port_m, jax_m = _fed("ConfusionMatrix")
    before, count = _states(port_m), port_m._update_count
    tree = _corrupt(cj.metric_state_pytree(jax_m), how)
    with pytest.raises(error):
        ct.restore_metric_state_pytree(port_m, tree)
    with pytest.raises(error):
        cj.restore_metric_state_pytree(mj.ConfusionMatrix(num_classes=C), tree)
    _unchanged(port_m, before, count)


def test_a_corrupt_dynamic_blob_fails_before_anything_is_bound():
    port_m, jax_m = _fed("ROC")
    before, count = _states(port_m), port_m._update_count
    tree = dict(cj.metric_state_pytree(jax_m))
    tree["_update_count"] = 99
    tree["_dynamic"] = np.frombuffer(b"{not json", dtype=np.uint8)
    with pytest.raises(ValueError, match="_dynamic"):
        ct.restore_metric_state_pytree(port_m, tree)
    _unchanged(port_m, before, count)
    assert port_m.num_classes == 1


def test_a_list_buffer_for_an_array_state_is_refused_and_a_list_state_restores_in_order():
    port_m, _ = _fed("SpearmanCorrCoef")
    tree = ct.metric_state_pytree(port_m)
    assert tree["_preds_is_list"] and sorted(tree["preds"]) == ["0", "1"]
    fresh = mt.SpearmanCorrCoef(device="cpu")
    ct.restore_metric_state_pytree(fresh, tree)
    assert [len(x) for x in fresh.preds] == [30, 21]
    tree["preds"] = np.concatenate(list(tree["preds"].values()))
    del tree["_preds_is_list"]
    with pytest.raises(ValueError, match="list buffer"):
        ct.restore_metric_state_pytree(mt.SpearmanCorrCoef(device="cpu"), tree)


def test_absent_or_drifted_health_counters_restore_as_zeros():
    port_m, jax_m = _fed("MeanMetric_skip")
    tree = cj.metric_state_pytree(jax_m)
    for drop in (True, False):
        t = dict(tree)
        if drop:
            del t["_health_counts"]
        else:
            t["_health_counts"] = np.zeros(3, dtype=np.int64)
        fresh = CASES["MeanMetric_skip"][1](mt, device="cpu")
        ct.restore_metric_state_pytree(fresh, t)
        assert fresh.health_report()["updates_quarantined"] == 0
        _assert_close(fresh.compute(), jax_m.compute())


@pytest.mark.parametrize("dtype,kind", [(torch.float16, "float"), (torch.int32, "int"), (torch.bool, "bool"), (np.uint8, "int"), (np.float64, "float")])
def test_dtype_kind(dtype, kind):
    assert ct.dtype_kind(dtype) == kind
    if not isinstance(dtype, torch.dtype):
        assert cj.dtype_kind(dtype) == kind


# ---------------------------------------------------------------------------
# bind_state
# ---------------------------------------------------------------------------
def test_bind_state_binds_casts_and_counts_like_jax():
    port_m, jax_m = _fed("ConfusionMatrix")
    state = {n: np.asarray(v) for n, v in jax_m._snapshot_state().items()}
    state["confmat"] = state["confmat"].astype(np.int32)
    fresh = mt.ConfusionMatrix(num_classes=C, device="cpu")
    fresh.compute_on_step = True
    assert fresh.bind_state(state, update_count=2) is fresh
    assert fresh.confmat.dtype == fresh._defaults["confmat"].dtype
    assert fresh._update_count == 2
    _assert_close(fresh.compute(), jax_m.compute())
    # a later bind clears the computed value
    fresh.bind_state(fresh.init_state())
    assert int(fresh.compute().sum()) == 0


def test_bind_state_takes_shape_polymorphic_states_in_any_shape():
    m = mt.R2Score(device="cpu")
    state = m.init_state()
    state["sum_squared_error"] = torch.ones(3)
    m.bind_state(state)
    assert m.sum_squared_error.shape == (3,)


@pytest.mark.parametrize(
    "change,match",
    [
        (lambda s: s.pop("confmat"), "missing"),
        (lambda s: s.update(extra=torch.zeros(1)), "unknown"),
        (lambda s: s.update(confmat=[s["confmat"]]), "list vs array"),
        (lambda s: s.update(confmat=torch.zeros(C + 1, C + 1, dtype=torch.int64)), "registered shape"),
        (lambda s: s.update(confmat=s["confmat"].float()), "kind mismatch"),
    ],
    ids=["missing", "unknown", "list", "shape", "kind"],
)
def test_bind_state_rejections_leave_the_metric_untouched(change, match):
    port_m, _ = _fed("ConfusionMatrix")
    before, count = _states(port_m), port_m._update_count
    state = dict(port_m._snapshot_state())
    change(state)
    with pytest.raises(MetricsUserError, match=match):
        port_m.bind_state(state, update_count=7)
    _unchanged(port_m, before, count)


def test_bind_state_resyncs_the_raise_mirrors():
    m = mt.MeanMetric(on_bad_input="raise", device="cpu")
    state = m.init_state()
    state["_health_counts"] = state["_health_counts"] + 3
    m.bind_state(state)
    m.update(torch.tensor([1.0, 2.0]))  # the counters moved outside an update: no spurious raise
    assert float(m.compute()) == 1.5


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------
def _collection(p, **d):
    return p.MetricCollection({"acc": p.Accuracy(num_classes=C, **d), "roc": p.ROC(num_classes=C, **d)})


def test_save_and_load_a_collection_through_weights_only(tmp_path):
    rng = np.random.default_rng(7)
    batches = [(rng.random((n, C)).astype(np.float32), rng.integers(0, C, n)) for n in (20, 13)]
    mc, jc = _collection(mt, device="cpu"), _collection(mj)
    for batch in batches:
        mc.update(*map(torch.from_numpy, batch))
        jc.update(*map(jnp.asarray, batch))
    path = str(tmp_path / "metrics.pt")
    ct.save_metric_state(path, mc)
    raw = torch.load(path, weights_only=True)  # no code runs on load
    assert sorted(raw) == ["acc", "roc"] and isinstance(raw["acc"]["_update_count"], int)
    fresh = _collection(mt, device="cpu")
    assert ct.load_metric_state(path, fresh) is fresh
    got, want = fresh.compute(), jc.compute()
    _assert_close(got["acc"], want["acc"])
    _assert_close(got["roc"], want["roc"])


def test_save_and_load_one_metric(tmp_path):
    port_m, jax_m = _fed("F1Score_mask")
    path = str(tmp_path / "f1.pt")
    ct.save_metric_state(path, port_m)
    fresh = CASES["F1Score_mask"][1](mt, device="cpu")
    ct.load_metric_state(path, fresh)
    _assert_close(fresh.compute(), jax_m.compute())
    assert fresh.health_report()["batches_screened"] == port_m.health_report()["batches_screened"] == 2

"""The port's curve and calibration metrics against ``metrics_tpu`` on the same
numpy batches: the binned curve family, ``AUROC`` in its three modes,
``CalibrationError`` in both modes, the exact curve modules and the
functional forms, and state carried across from JAX mid-stream. The port
runs on ``device="cpu"`` (the plain versions of its kernels).

Tolerances: counts exact; per-bin float sums 1e-5 relative; scores 1e-6
absolute, the JAX package's own curve tests' ``atol``.

Thresholds: an int ``thresholds`` gives float64 thresholds in the JAX package
(under x64, as ``tests/conftest.py`` sets it) and float32 ones in the port.
The data is kept off those grid points (asserted), so the two compare alike.
List thresholds are exactly representable in float32, so both packages hold
the same values; ``AUROC`` and ``CalibrationError`` use float32 grids in both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mj
import metrics_tpu.functional as fj
import metrics_tpu_torch as mt
import metrics_tpu_torch.functional as ft

ATOL = 1e-6
C = 5
BATCH = 40
INT_THRESHOLDS = 11
LIST_THRESHOLDS = [0.75, 0.25, 0.5, 0.25, 0.0, 1.0, 0.625]  # unsorted, one repeat; exact in float32


def _batches(kind: str, seed: int, n_batches: int = 4):
    """``n_batches`` (preds, target) numpy pairs, the last one ragged."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        n = BATCH - 7 * (i == n_batches - 1)
        if kind == "binary":
            target = rng.integers(0, 2, n)
            preds = (rng.random(n) * 0.6 + 0.4 * target).astype(np.float32)
        elif kind == "multilabel":
            target = rng.integers(0, 2, (n, C))
            preds = (rng.random((n, C)) * 0.7 + 0.3 * target).astype(np.float32)
        else:  # multiclass probabilities
            target = rng.integers(0, C, n)
            logits = rng.standard_normal((n, C)) + 1.5 * np.eye(C)[target]
            preds = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
        out.append((preds, target))
    grid64 = np.linspace(0, 1, INT_THRESHOLDS)
    assert not any(np.isin(p, grid64.astype(np.float32)).any() for p, _ in out), "data on a threshold grid point"
    return out


def _to_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_close(got, want, atol: float = ATOL) -> None:
    """Trees of tensors: integers exact, floats within ``atol``."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_close(g, w, atol)
        return
    g, w = _to_np(got), _to_np(want)
    assert g.shape == w.shape
    if w.dtype.kind in "iu":
        assert g.dtype.kind in "iu"
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


def _run_both(port_m, jax_m, batches):
    """forward on even batches, update on odd ones; batch values and the
    final value compared."""
    for i, (preds, target) in enumerate(batches):
        if i % 2 == 0:
            _assert_close(port_m(torch.from_numpy(preds), torch.from_numpy(target)), jax_m(jnp.asarray(preds), jnp.asarray(target)))
        else:
            port_m.update(torch.from_numpy(preds), torch.from_numpy(target))
            jax_m.update(jnp.asarray(preds), jnp.asarray(target))
    _assert_close(port_m.compute(), jax_m.compute())


BINNED_CASES = [
    (name, kind, thresholds)
    for name in ("BinnedPrecisionRecallCurve", "BinnedAveragePrecision", "BinnedRecallAtFixedPrecision")
    for kind in ("binary", "multilabel", "multiclass")
    for thresholds in (INT_THRESHOLDS, LIST_THRESHOLDS)
]


@pytest.mark.parametrize("name,kind,thresholds", BINNED_CASES, ids=[f"{n}-{k}-{type(t).__name__}" for n, k, t in BINNED_CASES])
def test_binned_curves_match_jax(name, kind, thresholds):
    kwargs = {"num_classes": 1 if kind == "binary" else C, "thresholds": thresholds}
    if name == "BinnedRecallAtFixedPrecision":
        kwargs["min_precision"] = 0.6
    port_m = getattr(mt, name)(device="cpu", **kwargs)
    jax_m = getattr(mj, name)(**kwargs)
    _run_both(port_m, jax_m, _batches(kind, seed=len(name) + len(kind)))
    for state in ("TPs", "FPs", "FNs"):  # float32 counters in both packages: exact
        np.testing.assert_array_equal(getattr(port_m, state).numpy(), np.asarray(getattr(jax_m, state)))


def test_binned_thresholds_given_as_a_float32_array_match_jax():
    ths = np.linspace(0, 1, 23).astype(np.float32)
    port_m = mt.BinnedAveragePrecision(num_classes=C, thresholds=torch.from_numpy(ths), device="cpu")
    jax_m = mj.BinnedAveragePrecision(num_classes=C, thresholds=jnp.asarray(ths))
    _run_both(port_m, jax_m, _batches("multilabel", seed=2))


AUROC_CASES = [
    ("binary", {}),
    ("binary", {"max_fpr": 0.5}),
    ("binary", {"buffer_capacity": 200}),
    ("binary", {"thresholds": 50}),
    ("binary", {"thresholds": [0.0, 0.125, 0.25, 0.5, 0.75, 1.0]}),
    ("multiclass", {"num_classes": C}),
    ("multiclass", {"num_classes": C, "average": "weighted"}),
    ("multiclass", {"num_classes": C, "buffer_capacity": 200}),
    ("multilabel", {"num_classes": C}),
    ("multilabel", {"num_classes": C, "average": "micro"}),
    ("multilabel", {"num_classes": C, "buffer_capacity": 200, "multilabel": True}),
]


@pytest.mark.parametrize("kind,kwargs", AUROC_CASES, ids=[f"{k}-{'-'.join(map(str, a)) or 'exact'}" for k, a in AUROC_CASES])
def test_auroc_matches_jax(kind, kwargs):
    port_m = mt.AUROC(device="cpu", **kwargs)
    jax_m = mj.AUROC(**kwargs)
    # the exact modes recompute whole curves (slow on the JAX side): two batches
    n_batches = 4 if "thresholds" in kwargs else 2
    _run_both(port_m, jax_m, _batches(kind, seed=len(kwargs) + len(kind), n_batches=n_batches))
    assert port_m.mode == jax_m.mode


def test_auroc_bounded_buffer_overflow_raises_like_jax():
    batches = _batches("binary", seed=4, n_batches=2)
    for m, wrap in ((mt.AUROC(buffer_capacity=50, device="cpu"), torch.from_numpy), (mj.AUROC(buffer_capacity=50), jnp.asarray)):
        for preds, target in batches:
            m.update(wrap(preds), wrap(target))
        with pytest.raises(ValueError, match="buffer_capacity exceeded"):
            m.compute()


def test_auroc_binned_mode_rejects_what_jax_rejects():
    for pkg, dev in ((mj, {}), (mt, {"device": "cpu"})):
        with pytest.raises(ValueError, match="mutually exclusive"):
            pkg.AUROC(thresholds=10, buffer_capacity=5, **dev)
        with pytest.raises(ValueError, match="max_fpr"):
            pkg.AUROC(thresholds=10, max_fpr=0.5, **dev)
    preds, target = _batches("multiclass", seed=5, n_batches=1)[0]
    with pytest.raises(ValueError, match="only supports binary"):
        mt.AUROC(thresholds=10, device="cpu").update(torch.from_numpy(preds), torch.from_numpy(target))


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_calibration_error_matches_jax(kind, norm, streaming):
    port_m = mt.CalibrationError(n_bins=10, norm=norm, streaming_bins=streaming, device="cpu")
    jax_m = mj.CalibrationError(n_bins=10, norm=norm, streaming_bins=streaming)
    _run_both(port_m, jax_m, _batches(kind, seed=len(norm) + 3 * streaming))
    if streaming:
        np.testing.assert_array_equal(port_m.bin_count.numpy(), np.asarray(jax_m.bin_count))
        for state in ("bin_conf", "bin_acc"):
            np.testing.assert_allclose(getattr(port_m, state).numpy(), np.asarray(getattr(jax_m, state)), rtol=1e-5)


def test_calibration_error_modes_agree_on_edge_confidences():
    """Confidences on bin boundaries, at 0 and above 1: the streaming and the
    buffered modes bin them alike, and both as the JAX package does."""
    bounds = np.asarray(jnp.linspace(0, 1, 6, dtype=jnp.float32))
    conf = np.concatenate([bounds, bounds, [1.5, 0.0, 0.3, 0.7]]).astype(np.float32)
    target = np.arange(len(conf)) % 2
    want = mj.CalibrationError(n_bins=5)(jnp.asarray(conf), jnp.asarray(target))
    for streaming in (False, True):
        got = mt.CalibrationError(n_bins=5, streaming_bins=streaming, device="cpu")(torch.from_numpy(conf), torch.from_numpy(target))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


EXACT_MODULE_CASES = [
    ("PrecisionRecallCurve", "binary", {}),
    ("PrecisionRecallCurve", "multiclass", {"num_classes": C}),
    ("PrecisionRecallCurve", "multilabel", {"num_classes": C}),
    ("PrecisionRecallCurve", "binary", {"buffer_capacity": 200}),
    ("ROC", "binary", {}),
    ("ROC", "multiclass", {"num_classes": C}),
    ("ROC", "multilabel", {"num_classes": C, "buffer_capacity": 200, "multilabel": True}),
    ("AveragePrecision", "binary", {}),
    ("AveragePrecision", "multiclass", {"num_classes": C}),
    ("AveragePrecision", "multiclass", {"num_classes": C, "average": "weighted"}),
    ("AveragePrecision", "multilabel", {"num_classes": C, "average": "micro"}),
    ("AveragePrecision", "multilabel", {"num_classes": C, "average": "none"}),
]


@pytest.mark.parametrize("name,kind,kwargs", EXACT_MODULE_CASES, ids=[f"{n}-{k}-{i}" for i, (n, k, _) in enumerate(EXACT_MODULE_CASES)])
def test_exact_curve_modules_match_jax(name, kind, kwargs):
    port_m = getattr(mt, name)(device="cpu", **kwargs)
    jax_m = getattr(mj, name)(**kwargs)
    _run_both(port_m, jax_m, _batches(kind, seed=len(name) + len(kwargs), n_batches=2))


def test_auc_module_matches_jax():
    rng = np.random.default_rng(6)
    x = np.cumsum(rng.random(30)).astype(np.float32)
    y = rng.random(30).astype(np.float32)
    port_m, jax_m = mt.AUC(device="cpu"), mj.AUC()
    for s in (slice(0, 12), slice(12, 30)):
        port_m.update(torch.from_numpy(x[s]), torch.from_numpy(y[s]))
        jax_m.update(jnp.asarray(x[s]), jnp.asarray(y[s]))
    _assert_close(port_m.compute(), jax_m.compute())


FUNCTIONAL_CASES = [
    ("calibration_error", "binary", {"n_bins": 7}),
    ("calibration_error", "multiclass", {"norm": "l2"}),
    ("calibration_error", "multiclass", {"norm": "max", "n_bins": 4}),
    ("roc", "binary", {}),
    ("roc", "multiclass", {"num_classes": C}),
    ("roc", "multilabel", {"num_classes": C}),
    ("precision_recall_curve", "binary", {}),
    ("precision_recall_curve", "multiclass", {"num_classes": C}),
    ("precision_recall_curve", "multilabel", {"num_classes": C}),
    ("average_precision", "binary", {}),
    ("average_precision", "multiclass", {"num_classes": C, "average": "weighted"}),
    ("average_precision", "multilabel", {"num_classes": C, "average": None}),
    ("auroc", "binary", {}),
    ("auroc", "binary", {"max_fpr": 0.3}),
    ("auroc", "multiclass", {"num_classes": C, "average": None}),
    ("auroc", "multilabel", {"num_classes": C, "average": "weighted"}),
]


@pytest.mark.parametrize("name,kind,kwargs", FUNCTIONAL_CASES, ids=[f"{n}-{k}-{i}" for i, (n, k, _) in enumerate(FUNCTIONAL_CASES)])
def test_functional_matches_jax(name, kind, kwargs):
    preds, target = _batches(kind, seed=17, n_batches=1)[0]
    got = getattr(ft, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    _assert_close(got, getattr(fj, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs))


@pytest.mark.parametrize("reorder", [False, True])
def test_functional_auc_matches_jax(reorder):
    rng = np.random.default_rng(9)
    x = rng.random(25).astype(np.float32)
    x = x if reorder else np.sort(x)[::-1].copy()  # decreasing x without reorder
    y = rng.random(25).astype(np.float32)
    _assert_close(ft.auc(torch.from_numpy(x), torch.from_numpy(y), reorder=reorder), fj.auc(jnp.asarray(x), jnp.asarray(y), reorder=reorder))


def test_functional_auc_rejects_non_monotone_x_like_jax():
    x, y = np.array([0.0, 1.0, 0.5], np.float32), np.array([0.0, 1.0, 1.0], np.float32)
    with pytest.raises(ValueError, match="neither increasing or decreasing"):
        fj.auc(jnp.asarray(x), jnp.asarray(y))
    with pytest.raises(ValueError, match="neither increasing or decreasing"):
        ft.auc(torch.from_numpy(x), torch.from_numpy(y))


CARRY_CASES = [
    ("BinnedAveragePrecision", "multilabel", {"num_classes": C, "thresholds": 9}, None),
    ("CalibrationError", "multiclass", {"n_bins": 8, "streaming_bins": True}, None),
    ("AUROC", "binary", {"thresholds": 30}, "mode"),
]


@pytest.mark.parametrize("name,kind,kwargs,dynamic", CARRY_CASES, ids=[c[0] for c in CARRY_CASES])
def test_state_carries_across_from_jax_mid_stream(name, kind, kwargs, dynamic):
    """JAX updates batches 1-2; the port takes its state and updates 3-4; the
    result equals JAX over batches 1-4."""
    batches = _batches(kind, seed=21)
    jax_m = getattr(mj, name)(**kwargs)
    for preds, target in batches[:2]:
        jax_m.update(jnp.asarray(preds), jnp.asarray(target))
    jax_m.persistent(True)
    state = mt.state_from_jax(jax_m.state_dict(), dynamic={dynamic: getattr(jax_m, dynamic)} if dynamic else None)
    port_m = getattr(mt, name)(device="cpu", **kwargs)
    result = port_m.load_state_dict(state)
    assert not result.missing_keys and not result.unexpected_keys
    for preds, target in batches[2:]:
        port_m.update(torch.from_numpy(preds), torch.from_numpy(target))
        jax_m.update(jnp.asarray(preds), jnp.asarray(target))
    _assert_close(port_m.compute(), jax_m.compute())


def test_curve_metrics_without_device_need_cuda():
    if torch.cuda.is_available():
        assert mt.CalibrationError().device.type == "cuda"
        assert mt.AUROC(thresholds=10).thresholds.device.type == "cuda"
    else:
        for build in (mt.CalibrationError, lambda: mt.AUROC(thresholds=10), lambda: mt.BinnedAveragePrecision(num_classes=2, thresholds=5)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                build()


def test_binned_family_runs_one_kernel_op_per_update():
    """Each update is one ``binned_counts`` dispatch (here its plain version),
    and ``CalibrationError(streaming_bins=True)`` one ``binned_calibration``."""
    mt.reset_kernel_stats()
    preds, target = _batches("multilabel", seed=1, n_batches=1)[0]
    m = mt.BinnedRecallAtFixedPrecision(num_classes=C, min_precision=0.5, thresholds=7, device="cpu")
    m.update(torch.from_numpy(preds), torch.from_numpy(target))
    m.compute()
    preds, target = _batches("multiclass", seed=1, n_batches=1)[0]
    ce = mt.CalibrationError(streaming_bins=True, device="cpu")
    ce.update(torch.from_numpy(preds), torch.from_numpy(target))
    ce.compute()
    stats = mt.kernel_stats()
    assert stats["binned_counts"] == {"launches": 0, "plain_calls": 1}
    assert stats["binned_calibration"] == {"launches": 0, "plain_calls": 1}


def _edge_class_batches(seed: int):
    """Multilabel batches in which class 0 has no positive, class 1 no
    negative, class 2's scores sit on two values (so many thresholds tie in
    recall and precision) and class 3's precision never reaches 0.9."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (40, 40, 33):
        target = rng.integers(0, 2, (n, C))
        preds = rng.random((n, C)).astype(np.float32)
        target[:, 0] = 0
        target[:, 1] = 1
        preds[:, 2] = np.where(target[:, 2] == 1, 0.73, 0.21).astype(np.float32)
        preds[:, 3] = (rng.random(n) * 0.3 + 0.7 * (1 - target[:, 3])).astype(np.float32)
        out.append((preds, target))
    return out


@pytest.mark.parametrize("min_precision", [0.0, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("thresholds", [INT_THRESHOLDS, LIST_THRESHOLDS])
def test_binned_vectorized_compute_matches_jax_on_edge_classes(thresholds, min_precision):
    """The ``[C, T]`` compute of AP and recall at precision against the JAX
    package's per-class loop: classes with no positive or no negative, ties
    in recall at the best precision (the greatest tied threshold wins) and a
    class where no threshold qualifies ``(0, 1e6)``. Per-class AP stays a list
    of 0-d tensors, recall at precision two ``[C]`` tensors."""
    batches = _edge_class_batches(seed=59)
    port_ap = mt.BinnedAveragePrecision(num_classes=C, thresholds=thresholds, device="cpu")
    jax_ap = mj.BinnedAveragePrecision(num_classes=C, thresholds=thresholds)
    _run_both(port_ap, jax_ap, batches)
    got = port_ap.compute()
    assert isinstance(got, list) and all(v.ndim == 0 for v in got)
    kwargs = {"num_classes": C, "thresholds": thresholds, "min_precision": min_precision}
    port_r = mt.BinnedRecallAtFixedPrecision(device="cpu", **kwargs)
    jax_r = mj.BinnedRecallAtFixedPrecision(**kwargs)
    _run_both(port_r, jax_r, batches)
    recall, threshold = port_r.compute()
    assert recall.shape == threshold.shape == (C,)

"""The port's classification slice against ``metrics_tpu`` on the same numpy
batches: module metrics over several ``forward``/``update`` calls, the
functional forms, and ``MetricCollection``. The port runs on ``device="cpu"``
(the plain versions of its kernels). Counts must match exactly; float scores
(Jaccard and Dice among them) within 1e-6 relative (both packages score in
float32); Cohen's kappa and MCC within 1e-6 relative or 1e-6 absolute (near
0 each is a difference of two O(1) float32 values, whose last bits differ
with the summation order); the float32 sums of the hinge loss and the KL
divergence within 1e-5 relative. The JAX side counts in int64 or int32
depending on the x64 lane (``CohenKappa`` and ``MatthewsCorrCoef`` keep
int32 there, int64 in the port), so dtypes are compared by kind.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mj
import metrics_tpu.functional as fj
import metrics_tpu_torch as mt
import metrics_tpu_torch.functional as ft

RTOL = 1e-6
N_CLASSES = 7
BATCH = 48


def _batches(kind: str, seed: int, n_batches: int = 4):
    """``n_batches`` of (preds, target) numpy pairs for one input case."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        n = BATCH - 5 * (i == n_batches - 1)  # ragged last batch
        if kind == "logits":
            preds = rng.standard_normal((n, N_CLASSES)).astype(np.float32)
            target = rng.integers(0, N_CLASSES, n)
        elif kind == "labels":
            preds, target = rng.integers(0, N_CLASSES, n), rng.integers(0, N_CLASSES, n)
        elif kind == "mdmc":  # multidim multiclass: (N, C, X) scores, (N, X) labels
            preds = rng.standard_normal((n, N_CLASSES, 3)).astype(np.float32)
            target = rng.integers(0, N_CLASSES, (n, 3))
        elif kind == "multilabel":
            preds = rng.random((n, N_CLASSES)).astype(np.float32)
            target = rng.integers(0, 2, (n, N_CLASSES))
        elif kind in ("dist", "logdist"):  # two distributions over the classes (p, q)
            a = rng.random((n, N_CLASSES)).astype(np.float32) + 0.05
            b = rng.random((n, N_CLASSES)).astype(np.float32) + 0.05
            if kind == "logdist":
                a = np.log(a / a.sum(1, keepdims=True)).astype(np.float32)
                b = np.log(b / b.sum(1, keepdims=True)).astype(np.float32)
            preds, target = a, b
        elif kind == "seg":  # [N, C, H, W] scores and [N, H, W] labels
            preds = rng.standard_normal((n // 8, N_CLASSES, 4, 5)).astype(np.float32)
            target = rng.integers(0, N_CLASSES, (n // 8, 4, 5))
        else:  # binary probabilities
            preds, target = rng.random(n).astype(np.float32), rng.integers(0, 2, n)
        out.append((preds, target))
    return out


def _assert_close(got, want, rtol: float = RTOL, atol: float = 0.0) -> None:
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if want.dtype.kind in "iu":
        assert got.dtype.kind in "iu"
        np.testing.assert_array_equal(got, want)
    else:
        assert got.dtype.kind == "f"
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# (name, input kind, constructor kwargs shared by both packages)
CASES = [
    ("Accuracy", "logits", {}),
    ("Accuracy", "logits", {"num_classes": N_CLASSES, "top_k": 3}),
    ("Accuracy", "logits", {"num_classes": N_CLASSES, "average": "macro"}),
    ("Accuracy", "labels", {"num_classes": N_CLASSES, "average": "weighted"}),
    ("Accuracy", "multilabel", {"num_classes": N_CLASSES}),
    ("Accuracy", "multilabel", {"subset_accuracy": True}),
    ("Accuracy", "binary", {}),
    ("Accuracy", "mdmc", {"num_classes": N_CLASSES, "average": "macro", "mdmc_average": "samplewise"}),
    ("Accuracy", "mdmc", {"subset_accuracy": True}),
    ("F1Score", "logits", {"num_classes": N_CLASSES, "average": "macro"}),
    ("F1Score", "logits", {"num_classes": N_CLASSES, "average": "none"}),
    ("F1Score", "logits", {"num_classes": N_CLASSES, "average": "macro", "top_k": 2}),
    ("FBetaScore", "labels", {"num_classes": N_CLASSES, "beta": 0.5, "average": "micro"}),
    ("F1Score", "mdmc", {"num_classes": N_CLASSES, "average": "weighted", "mdmc_average": "global", "ignore_index": 1}),
    ("StatScores", "logits", {"num_classes": N_CLASSES, "reduce": "macro"}),
    ("StatScores", "logits", {"reduce": "samples"}),
    ("ConfusionMatrix", "logits", {"num_classes": N_CLASSES}),
    ("ConfusionMatrix", "labels", {"num_classes": N_CLASSES, "normalize": "true"}),
    ("ConfusionMatrix", "multilabel", {"num_classes": N_CLASSES, "multilabel": True}),
    ("ConfusionMatrix", "binary", {"num_classes": 2}),
    ("Precision", "logits", {"num_classes": N_CLASSES, "average": "macro", "top_k": 3}),
    ("Precision", "labels", {"num_classes": N_CLASSES, "average": "none"}),
    ("Precision", "mdmc", {"num_classes": N_CLASSES, "average": "weighted", "mdmc_average": "samplewise", "ignore_index": 2}),
    ("Recall", "logits", {"average": "micro"}),
    ("Recall", "multilabel", {"num_classes": N_CLASSES, "average": "samples"}),
    ("Recall", "mdmc", {"num_classes": N_CLASSES, "average": "macro", "mdmc_average": "global"}),
    ("Specificity", "logits", {"num_classes": N_CLASSES, "average": "macro"}),
    ("Specificity", "binary", {}),
    ("Specificity", "labels", {"num_classes": N_CLASSES, "average": "none", "ignore_index": 0}),
    ("HammingDistance", "logits", {}),
    ("HammingDistance", "multilabel", {"threshold": 0.3}),
    ("HammingDistance", "mdmc", {}),
    ("CohenKappa", "logits", {"num_classes": N_CLASSES}),
    ("CohenKappa", "labels", {"num_classes": N_CLASSES, "weights": "linear"}),
    ("CohenKappa", "labels", {"num_classes": N_CLASSES, "weights": "quadratic"}),
    ("CohenKappa", "binary", {"num_classes": 2, "weights": "none"}),
    ("MatthewsCorrCoef", "logits", {"num_classes": N_CLASSES}),
    ("MatthewsCorrCoef", "binary", {"num_classes": 2, "threshold": 0.3}),
    ("JaccardIndex", "logits", {"num_classes": N_CLASSES}),
    ("JaccardIndex", "labels", {"num_classes": N_CLASSES, "ignore_index": 2, "reduction": "none"}),
    ("JaccardIndex", "seg", {"num_classes": N_CLASSES, "ignore_index": N_CLASSES - 1, "absent_score": 0.5}),
    ("JaccardIndex", "binary", {"num_classes": 2, "reduction": "sum"}),
    ("HingeLoss", "binary", {}),
    ("HingeLoss", "logits", {"squared": True}),
    ("HingeLoss", "logits", {"multiclass_mode": "one-vs-all"}),
    ("KLDivergence", "dist", {}),
    ("KLDivergence", "logdist", {"log_prob": True, "reduction": "sum"}),
    ("KLDivergence", "dist", {"reduction": "none"}),
]

# float32 sums: 1e-5 relative; kappa and MCC also 1e-6 absolute
SUM_METRICS = ("HingeLoss", "KLDivergence")
AGREEMENT_METRICS = ("CohenKappa", "MatthewsCorrCoef", "cohen_kappa", "matthews_corrcoef")


@pytest.mark.parametrize("name,kind,kwargs", CASES, ids=[f"{c[0]}-{c[1]}-{i}" for i, c in enumerate(CASES)])
def test_module_metric_matches_jax(name, kind, kwargs):
    jax_m = getattr(mj, name)(**kwargs)
    port_m = getattr(mt, name)(device="cpu", **kwargs)
    rtol = 1e-5 if name in SUM_METRICS else RTOL
    atol = 1e-6 if name in AGREEMENT_METRICS else 0.0
    for i, (preds, target) in enumerate(_batches(kind, seed=len(name) + len(kwargs))):
        if i % 2 == 0:  # forward: batch value and accumulation
            _assert_close(port_m(torch.from_numpy(preds), torch.from_numpy(target)), jax_m(jnp.asarray(preds), jnp.asarray(target)), rtol, atol)
        else:
            port_m.update(torch.from_numpy(preds), torch.from_numpy(target))
            jax_m.update(jnp.asarray(preds), jnp.asarray(target))
    _assert_close(port_m.compute(), jax_m.compute(), rtol, atol)
    for state in jax_m._defaults:
        jv, pv = getattr(jax_m, state), getattr(port_m, state)
        if isinstance(jv, list):
            for pj, pp in zip(jv, pv):
                _assert_close(pp, pj, rtol)
        else:
            _assert_close(pv, jv, rtol)
    port_m.reset()
    assert all(int(torch.count_nonzero(torch.as_tensor(getattr(port_m, s)))) == 0 for s in port_m._defaults if not isinstance(getattr(port_m, s), list))


FUNCTIONAL_CASES = [
    ("accuracy", "logits", {"num_classes": N_CLASSES, "top_k": 2}),
    ("accuracy", "logits", {"num_classes": N_CLASSES, "average": "macro"}),
    ("accuracy", "multilabel", {"subset_accuracy": True}),
    ("f1_score", "logits", {"num_classes": N_CLASSES, "average": "macro"}),
    ("fbeta_score", "multilabel", {"num_classes": N_CLASSES, "beta": 2.0, "average": "weighted"}),
    ("confusion_matrix", "logits", {"num_classes": N_CLASSES}),
    ("confusion_matrix", "multilabel", {"num_classes": N_CLASSES, "multilabel": True}),
    ("stat_scores", "labels", {"num_classes": N_CLASSES, "reduce": "macro", "ignore_index": 2}),
]


@pytest.mark.parametrize("name,kind,kwargs", FUNCTIONAL_CASES, ids=[f"{c[0]}-{c[1]}-{i}" for i, c in enumerate(FUNCTIONAL_CASES)])
def test_functional_matches_jax(name, kind, kwargs):
    preds, target = _batches(kind, seed=11, n_batches=1)[0]
    got = getattr(ft, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    _assert_close(got, getattr(fj, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs))


SCORE_FUNCTIONS = ("precision", "recall", "precision_recall", "specificity")
AVERAGES = ("micro", "macro", "weighted", "none", "samples")


def _score_combinations(kind: str):
    """Every mdmc_average / ignore_index / top_k setting tried for one input kind."""
    mdmc = (None, "global", "samplewise") if kind == "mdmc" else (None,)
    top_k = (None, 2) if kind in ("logits", "mdmc") else (None,)
    return [
        {"mdmc_average": m, "ignore_index": i, "top_k": k}
        for m in mdmc
        for i in (None, 1)
        for k in top_k
    ]


@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize("kind", ["logits", "labels", "multilabel", "binary", "mdmc"])
@pytest.mark.parametrize("name", SCORE_FUNCTIONS)
def test_score_functional_matches_jax_over_its_settings(name, kind, average):
    """Each setting that ``metrics_tpu`` accepts gives its value; each that it
    rejects with a ValueError is rejected by the port with the same message."""
    preds, target = _batches(kind, seed=17, n_batches=1)[0]
    for combo in _score_combinations(kind):
        kwargs = {"num_classes": N_CLASSES if kind != "binary" else None, "average": average, **combo}
        try:
            want = getattr(fj, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
        except ValueError as err:
            with pytest.raises(ValueError) as port_err:
                getattr(ft, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
            assert str(port_err.value) == str(err), kwargs
            continue
        got = getattr(ft, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
        for g, w in zip(got, want) if name == "precision_recall" else [(got, want)]:
            _assert_close(g, w)


@pytest.mark.parametrize("kind", ["logits", "labels", "multilabel", "binary", "mdmc"])
def test_hamming_distance_functional_matches_jax(kind):
    preds, target = _batches(kind, seed=19, n_batches=1)[0]
    for threshold in (0.5, 0.2):
        got = ft.hamming_distance(torch.from_numpy(preds), torch.from_numpy(target), threshold=threshold)
        _assert_close(got, fj.hamming_distance(jnp.asarray(preds), jnp.asarray(target), threshold=threshold))


def _main_path_members(pkg, **dev):
    return {
        "top1": pkg.Accuracy(num_classes=N_CLASSES, **dev),
        "top5": pkg.Accuracy(num_classes=N_CLASSES, top_k=3, **dev),
        "f1": pkg.F1Score(num_classes=N_CLASSES, average="macro", **dev),
        "confmat": pkg.ConfusionMatrix(num_classes=N_CLASSES, **dev),
    }


def test_collection_matches_jax_over_a_stream():
    jax_mc = mj.MetricCollection(_main_path_members(mj), prefix="val_")
    port_mc = mt.MetricCollection(_main_path_members(mt, device="cpu"), prefix="val_")
    assert list(port_mc.keys()) == list(jax_mc.keys())
    for preds, target in _batches("logits", seed=3, n_batches=5):
        got = port_mc(torch.from_numpy(preds), torch.from_numpy(target))
        want = jax_mc(jnp.asarray(preds), jnp.asarray(target))
        assert got.keys() == want.keys()
        for key in want:
            _assert_close(got[key], want[key])
    got, want = port_mc.compute(), jax_mc.compute()
    for key in want:
        _assert_close(got[key], want[key])
    port_mc.reset()
    assert int(port_mc["confmat"].confmat.sum()) == 0


def test_pure_state_api_matches_module_path():
    port = mt.Accuracy(num_classes=N_CLASSES, top_k=3, device="cpu")
    batches = _batches("logits", seed=5, n_batches=3)
    state = port.init_state()
    halves = []
    for preds, target in batches:
        state = port.update_state(state, torch.from_numpy(preds), torch.from_numpy(target))
        halves.append(port.update_state(port.init_state(), torch.from_numpy(preds), torch.from_numpy(target)))
    merged = port.merge_states(port.merge_states(halves[0], halves[1]), halves[2])
    for key in state:
        _assert_close(merged[key], state[key].numpy())
    assert port._update_count == 0  # the pure API leaves the module's own state alone
    jax_m = mj.Accuracy(num_classes=N_CLASSES, top_k=3)
    for preds, target in batches:
        jax_m.update(jnp.asarray(preds), jnp.asarray(target))
    _assert_close(port.compute_state(state), jax_m.compute())


def test_collection_pure_api_matches_jax():
    """The collection's init/update/merge/compute_state over two halves of a
    stream equal the JAX collection over the whole stream."""
    port_mc = mt.MetricCollection(_main_path_members(mt, device="cpu"), prefix="val_")
    jax_mc = mj.MetricCollection(_main_path_members(mj), prefix="val_")
    batches = _batches("logits", seed=9, n_batches=4)
    whole, halves = port_mc.init_state(), [port_mc.init_state(), port_mc.init_state()]
    assert list(whole) == list(jax_mc.init_state())
    for i, (preds, target) in enumerate(batches):
        whole = port_mc.update_state(whole, torch.from_numpy(preds), torch.from_numpy(target))
        halves[i // 2] = port_mc.update_state(halves[i // 2], torch.from_numpy(preds), torch.from_numpy(target))
        jax_mc.update(jnp.asarray(preds), jnp.asarray(target))
    want = jax_mc.compute()
    for states in (whole, port_mc.merge_states(*halves)):
        got = port_mc.compute_state(states)
        assert got.keys() == want.keys()
        for key in want:
            _assert_close(got[key], want[key])
    assert all(m._update_count == 0 for _, m in port_mc.items())  # the members' own state is untouched


def test_metric_without_device_needs_cuda():
    if torch.cuda.is_available():
        assert mt.Accuracy().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mt.Accuracy()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mt.ConfusionMatrix(num_classes=3, device="cuda")


def test_input_errors_match_jax():
    """The value checks raise what the JAX package's eager path raises. Its
    jitted module update skips them, and so does the port's engine update
    (``tests/test_torch_engine.py``); the port's eager update keeps them."""
    preds = np.array([0, 1, 2])
    for target in (np.array([0, -1, 1]), np.array([0, 1, 9])):
        with pytest.raises(ValueError) as jax_err:
            fj.accuracy(jnp.asarray(preds), jnp.asarray(target), num_classes=3)
        with pytest.raises(ValueError) as port_err:
            ft.accuracy(torch.from_numpy(preds), torch.from_numpy(target), num_classes=3)
        assert str(port_err.value) == str(jax_err.value)
        with pytest.raises(ValueError, match=str(jax_err.value)[:20]):
            mt.Accuracy(num_classes=3, jit_update=False, device="cpu")(torch.from_numpy(preds), torch.from_numpy(target))


def test_moving_a_metric_moves_its_defaults():
    """``.to()`` moves the registered defaults with the states, so ``reset``
    keeps the metric on its new device."""
    m = mt.ConfusionMatrix(num_classes=3, device="cpu")
    m.update(torch.tensor([0, 1, 2]), torch.tensor([0, 1, 1]))
    m.to("meta")
    m.reset()
    assert m.device.type == "meta" and m.confmat.device.type == "meta"


# ---------------------------------------------------------------------------
# the rest of classification: every functional over its argument grid
# ---------------------------------------------------------------------------
def _both(name, preds, target, rtol=RTOL, **kwargs):
    """The functional ``name`` of both packages on one numpy batch: equal
    values, or the same ValueError message."""
    try:
        want = getattr(fj, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    except ValueError as err:
        with pytest.raises(ValueError) as port_err:
            getattr(ft, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
        assert str(port_err.value) == str(err), kwargs
        return
    atol = 1e-6 if name in AGREEMENT_METRICS else 0.0
    _assert_close(getattr(ft, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs), want, rtol, atol)


@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("mode", [None, "crammer-singer", "one-vs-all"])
@pytest.mark.parametrize("kind", ["binary", "logits"])
def test_hinge_loss_functional_matches_jax(kind, mode, squared):
    preds, target = _batches(kind, seed=23, n_batches=1)[0]
    if kind == "binary":
        preds = preds * 4 - 2  # margins on both sides of 1
    _both("hinge_loss", preds, target, rtol=1e-5, squared=squared, multiclass_mode=mode)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none", None])
@pytest.mark.parametrize("log_prob", [False, True])
def test_kl_divergence_functional_matches_jax(log_prob, reduction):
    p, q = _batches("logdist" if log_prob else "dist", seed=29, n_batches=1)[0]
    _both("kl_divergence", p, q, rtol=1e-5, log_prob=log_prob, reduction=reduction)


@pytest.mark.parametrize("weights", [None, "linear", "quadratic"])
@pytest.mark.parametrize("kind", ["logits", "labels", "binary", "mdmc"])
def test_cohen_kappa_and_mcc_functionals_match_jax(kind, weights):
    preds, target = _batches(kind, seed=31, n_batches=1)[0]
    c = 2 if kind == "binary" else N_CLASSES
    _both("cohen_kappa", preds, target, num_classes=c, weights=weights)
    _both("matthews_corrcoef", preds, target, num_classes=c, threshold=0.5 if weights is None else 0.25)


def test_kappa_and_mcc_edge_matrices_match_jax():
    """Perfect agreement, one class only (MCC's zero denominator) and all wrong."""
    for preds, target in (
        (np.array([0, 1, 2, 1]), np.array([0, 1, 2, 1])),
        (np.array([1, 1, 1, 1]), np.array([1, 1, 1, 1])),
        (np.array([1, 0, 1, 0]), np.array([0, 1, 0, 1])),
    ):
        for weights in (None, "linear", "quadratic"):
            _both("cohen_kappa", preds, target, num_classes=3, weights=weights)
        _both("matthews_corrcoef", preds, target, num_classes=3)


@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
@pytest.mark.parametrize("ignore_index", [None, 0, 3, N_CLASSES - 1, -1, N_CLASSES + 4])
@pytest.mark.parametrize("kind", ["logits", "labels", "seg", "binary"])
def test_jaccard_index_functional_matches_jax(kind, ignore_index, reduction):
    preds, target = _batches(kind, seed=37, n_batches=1)[0]
    c = 2 if kind == "binary" else N_CLASSES
    if kind == "labels":
        target = np.where(target == 4, 5, target)  # class 4 absent: its union is empty
        preds = np.where(preds == 4, 5, preds)
    for absent_score in (0.0, 0.25):
        _both("jaccard_index", preds, target, num_classes=c, ignore_index=ignore_index, absent_score=absent_score, reduction=reduction)


@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
@pytest.mark.parametrize("bg", [False, True])
@pytest.mark.parametrize("kind", ["logits", "seg", "labels2d"])
def test_dice_score_functional_matches_jax(kind, bg, reduction):
    if kind == "labels2d":  # labels of one shape (C is preds.shape[1])
        rng = np.random.default_rng(41)
        preds, target = rng.integers(0, 5, (6, 9)), rng.integers(0, 5, (6, 9))
        target[target == 3] = 4  # class 3 absent from target: no_fg_score
        preds[preds == 2] = 1
        target[target == 2] = 1  # class 2 absent from both
    else:
        preds, target = _batches(kind, seed=43, n_batches=1)[0]
        target = np.where(target == 2, 1, target)
    for nan_score, no_fg_score in ((0.0, 0.0), (0.5, 0.0), (0.0, -1.0), (0.75, 0.25)):
        _both("dice_score", preds, target, bg=bg, nan_score=nan_score, no_fg_score=no_fg_score, reduction=reduction)


def test_new_metrics_reject_what_jax_rejects():
    """Constructor and input errors: same exception type and message."""
    rng = np.random.default_rng(47)
    bad_inputs = [
        ("hinge_loss", rng.standard_normal((4, 3, 2)).astype(np.float32), rng.integers(0, 3, 4), {}),
        ("hinge_loss", rng.standard_normal((4, 3)).astype(np.float32), rng.integers(0, 3, (4, 2)), {}),
        ("hinge_loss", rng.standard_normal(4).astype(np.float32), rng.integers(0, 2, 5), {}),
        ("hinge_loss", rng.standard_normal((4, 3)).astype(np.float32), rng.integers(0, 3, 5), {}),
        ("hinge_loss", rng.standard_normal((4, 3)).astype(np.float32), rng.integers(0, 3, 4), {"multiclass_mode": "bogus"}),
        ("kl_divergence", rng.random((4, 3, 2)).astype(np.float32), rng.random((4, 3, 2)).astype(np.float32), {}),
        ("cohen_kappa", rng.integers(0, 3, 6), rng.integers(0, 3, 6), {"num_classes": 3, "weights": "cubic"}),
    ]
    for name, preds, target, kwargs in bad_inputs:
        _both(name, preds, target, **kwargs)
    with pytest.raises(RuntimeError) as jax_err:
        fj.kl_divergence(jnp.ones((2, 3)), jnp.ones((2, 4)))
    with pytest.raises(RuntimeError) as port_err:
        ft.kl_divergence(torch.ones(2, 3), torch.ones(2, 4))
    assert str(port_err.value) == str(jax_err.value)
    for name, kwargs, exc in (
        ("HingeLoss", {"multiclass_mode": "bogus"}, ValueError),
        ("KLDivergence", {"log_prob": 1}, TypeError),
        ("KLDivergence", {"reduction": "max"}, ValueError),
        ("CohenKappa", {"num_classes": 3, "weights": "cubic"}, ValueError),
    ):
        with pytest.raises(exc) as jax_err:
            getattr(mj, name)(**kwargs)
        with pytest.raises(exc) as port_err:
            getattr(mt, name)(device="cpu", **kwargs)
        assert str(port_err.value) == str(jax_err.value)


def test_new_confusion_metrics_run_the_confusion_counts_op_in_one_program():
    """Cohen's kappa, MCC and Jaccard update through ``confusion_counts``
    (its plain version here), inside an engine program: on the card that is
    one kernel launch per update, in a CUDA graph."""
    preds, target = _batches("seg", seed=53, n_batches=1)[0]
    members = {
        "kappa": mt.CohenKappa(num_classes=N_CLASSES, device="cpu"),
        "mcc": mt.MatthewsCorrCoef(num_classes=N_CLASSES, device="cpu"),
        "iou": mt.JaccardIndex(num_classes=N_CLASSES, ignore_index=0, device="cpu"),
    }
    mc = mt.MetricCollection(members)
    mt.reset_kernel_stats()
    for _ in range(2):
        mc(torch.from_numpy(preds), torch.from_numpy(target))
    stats = mt.kernel_stats()
    assert stats["confusion_counts"]["plain_calls"] == 2 * len(members)
    assert not any(m.compile_stats()["jit_failed"] for m in members.values())
    assert not mc._fused_fwd_failed

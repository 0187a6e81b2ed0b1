"""The port's classification slice against ``metrics_tpu`` on the same numpy
batches: module metrics over several ``forward``/``update`` calls, the
functional forms, and ``MetricCollection``. The port runs on ``device="cpu"``
(the plain versions of its kernels). Counts must match exactly; float scores
within 1e-6 relative (both packages score in float32). The JAX side counts
in int64 or int32 depending on the x64 lane, so dtypes are compared by kind.
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
        else:  # binary probabilities
            preds, target = rng.random(n).astype(np.float32), rng.integers(0, 2, n)
        out.append((preds, target))
    return out


def _assert_close(got, want) -> None:
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if want.dtype.kind in "iu":
        assert got.dtype.kind in "iu"
        np.testing.assert_array_equal(got, want)
    else:
        assert got.dtype.kind == "f"
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


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
]


@pytest.mark.parametrize("name,kind,kwargs", CASES, ids=[f"{c[0]}-{c[1]}-{i}" for i, c in enumerate(CASES)])
def test_module_metric_matches_jax(name, kind, kwargs):
    jax_m = getattr(mj, name)(**kwargs)
    port_m = getattr(mt, name)(device="cpu", **kwargs)
    for i, (preds, target) in enumerate(_batches(kind, seed=len(name) + len(kwargs))):
        if i % 2 == 0:  # forward: batch value and accumulation
            _assert_close(port_m(torch.from_numpy(preds), torch.from_numpy(target)), jax_m(jnp.asarray(preds), jnp.asarray(target)))
        else:
            port_m.update(torch.from_numpy(preds), torch.from_numpy(target))
            jax_m.update(jnp.asarray(preds), jnp.asarray(target))
    _assert_close(port_m.compute(), jax_m.compute())
    for state in jax_m._defaults:
        jv, pv = getattr(jax_m, state), getattr(port_m, state)
        if isinstance(jv, list):
            for pj, pp in zip(jv, pv):
                _assert_close(pp, pj)
        else:
            _assert_close(pv, jv)
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

"""Copying the port's metrics and collections: ``copy.deepcopy``, ``clone()``
and a ``pickle`` round trip, each held against ``metrics_tpu`` on the same
numpy batches.

A copy must own its state and its ``update``/``compute`` wrappers: its
updates leave the original alone, and a copy taken mid-stream carries on
exactly as the original would have. Counts match exactly; float values
within 1e-5 relative and 1e-6 absolute (the tolerances of the port's curve
and regression tests).
"""
import copy
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mj
import metrics_tpu_torch as mt

RTOL, ATOL = 1e-5, 1e-6
N_CLASSES = 5
BATCH = 40


def _batches(kind: str, seed: int, n_batches: int = 3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        n = BATCH - 3 * i  # ragged batches
        if kind == "logits":
            preds = rng.standard_normal((n, N_CLASSES)).astype(np.float32)
            target = rng.integers(0, N_CLASSES, n)
        elif kind == "probs":  # softmax rows, as calibration reads them
            z = np.exp(rng.standard_normal((n, N_CLASSES)) * 2)
            preds = (z / z.sum(1, keepdims=True)).astype(np.float32)
            target = rng.integers(0, N_CLASSES, n)
        elif kind == "multilabel":
            preds = rng.random((n, N_CLASSES)).astype(np.float32)
            target = rng.integers(0, 2, (n, N_CLASSES))
        elif kind == "binary":
            preds, target = rng.random(n).astype(np.float32), rng.integers(0, 2, n)
        else:  # regression
            target = rng.standard_normal(n).astype(np.float32)
            preds = (target + 0.3 * rng.standard_normal(n)).astype(np.float32)
        out.append((preds, target))
    return out


def _collection(pkg, **dev):
    """The ImageNet-style collection of the port's main path, at a small width."""
    return pkg.MetricCollection(
        {
            "top1": pkg.Accuracy(num_classes=N_CLASSES, **dev),
            "top3": pkg.Accuracy(num_classes=N_CLASSES, top_k=3, **dev),
            "f1": pkg.F1Score(num_classes=N_CLASSES, average="macro", **dev),
            "confmat": pkg.ConfusionMatrix(num_classes=N_CLASSES, **dev),
        }
    )


# id -> (input kind, factory(package, **device kwargs))
CASES = {
    "Accuracy": ("logits", lambda pkg, **dev: pkg.Accuracy(num_classes=N_CLASSES, **dev)),
    "MeanSquaredError": ("regression", lambda pkg, **dev: pkg.MeanSquaredError(**dev)),
    "AUROC": ("binary", lambda pkg, **dev: pkg.AUROC(**dev)),
    "CalibrationError": ("probs", lambda pkg, **dev: pkg.CalibrationError(n_bins=10, **dev)),
    "CalibrationError_streaming": ("probs", lambda pkg, **dev: pkg.CalibrationError(n_bins=10, streaming_bins=True, **dev)),
    "ConfusionMatrix_multilabel": (
        "multilabel", lambda pkg, **dev: pkg.ConfusionMatrix(num_classes=N_CLASSES, multilabel=True, **dev)
    ),
    "MetricCollection": ("logits", _collection),
}


def _pair(case: str):
    kind, factory = CASES[case]
    return factory(mt, device="cpu"), factory(mj), _batches(kind, seed=len(case))


def _feed(port_m, jax_m, batches, forward: bool = False):
    for preds, target in batches:
        args_t, args_j = (torch.from_numpy(preds), torch.from_numpy(target)), (jnp.asarray(preds), jnp.asarray(target))
        if forward:
            _assert_close(port_m(*args_t), jax_m(*args_j))
        else:
            port_m.update(*args_t)
            jax_m.update(*args_j)


def _assert_close(got, want) -> None:
    """Trees of tensors (dicts, lists, tuples): integers exact, floats within RTOL/ATOL."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_close(got[k], want[k])
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_close(g, w)
        return
    g, w = got.detach().cpu().numpy(), np.asarray(want)
    assert g.shape == w.shape
    if w.dtype.kind in "iu":
        assert g.dtype.kind in "iu"
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def _clone(m):
    return m.clone()


COPIES = {"deepcopy": copy.deepcopy, "clone": _clone, "pickle": lambda m: pickle.loads(pickle.dumps(m))}


@pytest.mark.parametrize("how", sorted(COPIES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_updates_of_a_copy_leave_the_original_alone(case, how):
    port_m, jax_m, batches = _pair(case)
    _feed(port_m, jax_m, batches[:1])
    port_c, jax_c = COPIES[how](port_m), copy.deepcopy(jax_m)
    _feed(port_c, jax_c, batches[1:])
    _assert_close(port_m.compute(), jax_m.compute())
    _assert_close(port_c.compute(), jax_c.compute())
    _feed(port_m, jax_m, batches[2:])  # and the original's updates leave the copy alone
    _assert_close(port_c.compute(), jax_c.compute())
    _assert_close(port_m.compute(), jax_m.compute())


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_pickle_round_trip_mid_stream_carries_on_like_metrics_tpu(case):
    port_m, jax_m, batches = _pair(case)
    _feed(port_m, jax_m, batches[:2])
    port_p, jax_p = pickle.loads(pickle.dumps(port_m)), pickle.loads(pickle.dumps(jax_m))
    _assert_close(port_p.compute(), jax_p.compute())
    _feed(port_p, jax_p, batches[2:])
    _assert_close(port_p.compute(), jax_p.compute())


@pytest.mark.parametrize("how", sorted(COPIES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_works_on_a_copy(case, how):
    port_m, jax_m, batches = _pair(case)
    _feed(port_m, jax_m, batches[:1], forward=True)
    port_c, jax_c = COPIES[how](port_m), copy.deepcopy(jax_m)
    _feed(port_c, jax_c, batches[1:], forward=True)  # batch values
    _assert_close(port_c.compute(), jax_c.compute())
    _assert_close(port_m.compute(), jax_m.compute())


def test_the_deepcopy_probe_gives_the_reference_answers():
    """A copy taken after one update, then updated once more: the original
    keeps 2 of 3 right, the copy has 2 of 7 (metrics_tpu's 0.6667 and 0.2857)."""
    values = {}
    for pkg, wrap, dev in ((mt, torch.tensor, {"device": "cpu"}), (mj, jnp.asarray, {})):
        m = pkg.Accuracy(num_classes=3, **dev)
        m.update(wrap([0, 1, 2]), wrap([0, 1, 1]))
        c = copy.deepcopy(m)
        c.update(wrap([0, 0, 0, 0]), wrap([1, 1, 1, 1]))
        values[pkg.__name__] = (float(m.compute()), float(c.compute()))
    assert values["metrics_tpu_torch"] == pytest.approx((2 / 3, 2 / 7), rel=1e-6)
    assert values["metrics_tpu_torch"] == pytest.approx(values["metrics_tpu"], rel=1e-6)


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"prefix": "val_"}, {"postfix": "_ep"}, {"prefix": "val_", "postfix": "_ep"}],
    ids=["keep", "prefix", "postfix", "both"],
)
@pytest.mark.parametrize("base", [{}, {"prefix": "train_", "postfix": "/1"}], ids=["bare", "named"])
def test_collection_clone_rekeys_like_the_reference(base, kwargs):
    port_mc, jax_mc = _collection(mt, device="cpu"), _collection(mj)
    port_mc.prefix = jax_mc.prefix = base.get("prefix")
    port_mc.postfix = jax_mc.postfix = base.get("postfix")
    batches = _batches("logits", seed=7)
    _feed(port_mc, jax_mc, batches[:1])
    port_c, jax_c = port_mc.clone(**kwargs), jax_mc.clone(**kwargs)
    assert port_c.keys() == list(jax_c.keys())
    assert port_c.keys(keep_base=True) == list(port_mc.keys(keep_base=True))
    _feed(port_c, jax_c, batches[1:])
    _assert_close(port_c.compute(), jax_c.compute())
    _assert_close(port_mc.compute(), jax_mc.compute())
    assert all(port_c[k] is not port_mc[k] for k in port_mc.keys(keep_base=True))


def test_collection_clone_rejects_a_prefix_that_is_not_a_string():
    with pytest.raises(ValueError, match="prefix"):
        _collection(mt, device="cpu").clone(prefix=3)


def test_a_copy_has_its_own_wrappers_and_warning_token():
    m = mt.MeanSquaredError(device="cpu")
    with pytest.warns(UserWarning, match="called before the ``update``"):
        m.compute()
    for c in (copy.deepcopy(m), m.clone(), pickle.loads(pickle.dumps(m))):
        assert c._inner_update.__self__ is c and c._compute_impl.__self__ is c
        assert c._warn_token != m._warn_token
        assert c.device == m.device and c._update_signature == m._update_signature
        with pytest.warns(UserWarning, match="called before the ``update``"):
            c.compute()  # its own warn-once history: warns though the original already did
        c.update(torch.tensor([0.0, 1.0]), torch.tensor([0.5, 1.0]))
        assert (c._update_count, m._update_count) == (1, 0)

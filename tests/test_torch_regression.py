"""The port's regression metrics against ``metrics_tpu`` on the same numpy
batches: every module streamed over three batches (``forward`` and
``update`` in turn, batch values and the final value compared), every
functional, the options (``compensated=``, R2's ``adjusted=`` and
``multioutput=``, Tweedie's powers, Spearman's ties and
``buffer_capacity=``), the error texts, Pearson's merge of stacked
per-replica states, and state carried across from JAX mid-stream. The port
runs on ``device="cpu"``.

Tolerances: 1e-5 relative, with a 1e-6 absolute floor for the correlations
and scores that can sit near 0. The JAX side runs with x64 on
(``tests/conftest.py``), so its states are float64 where the port's are
float32; float32 sums over a few hundred values agree well within 1e-5.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mj
import metrics_tpu.functional as fj
import metrics_tpu_torch as mt
import metrics_tpu_torch.functional as ft
from metrics_tpu_torch.obs.warn import reset_warn_once

RTOL, ATOL = 1e-5, 1e-6
BATCH = 40


@pytest.fixture(autouse=True)
def _fresh_port_warnings():
    reset_warn_once()
    yield
    reset_warn_once()


def _batches(seed: int, width: int = 1, n_batches: int = 3, ties: bool = False):
    """``n_batches`` positive (preds, target) pairs, ``[N]`` or ``[N, width]``;
    the last batch ragged. ``ties`` rounds both to a coarse grid."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        shape = (BATCH - 7 * (i == n_batches - 1),) + ((width,) if width > 1 else ())
        target = rng.random(shape) * 4 + 0.5
        preds = target * np.exp(rng.standard_normal(shape) * 0.3)
        if ties:
            target, preds = np.round(target * 2) / 2, np.round(preds * 2) / 2
        out.append((preds.astype(np.float32), target.astype(np.float32)))
    return out


def _to_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_close(got, want) -> None:
    g, w = _to_np(got), _to_np(want)
    assert g.shape == w.shape
    assert g.dtype.kind == w.dtype.kind
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def _run_both(port_m, jax_m, batches):
    for i, (preds, target) in enumerate(batches):
        if i % 2 == 0:
            _assert_close(port_m(torch.from_numpy(preds), torch.from_numpy(target)), jax_m(jnp.asarray(preds), jnp.asarray(target)))
        else:
            port_m.update(torch.from_numpy(preds), torch.from_numpy(target))
            jax_m.update(jnp.asarray(preds), jnp.asarray(target))
    _assert_close(port_m.compute(), jax_m.compute())


def _make(name: str, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the buffering metrics' memory warning
        return getattr(mt, name)(device="cpu", **kwargs), getattr(mj, name)(**kwargs)


MODULES = [
    ("MeanSquaredError", {}, 1),
    ("MeanSquaredError", {"squared": False}, 1),
    ("MeanSquaredError", {"compensated": True}, 1),
    ("MeanSquaredError", {"squared": False, "compensated": True}, 3),
    ("MeanAbsoluteError", {}, 1),
    ("MeanAbsoluteError", {"compensated": True}, 1),
    ("MeanSquaredLogError", {}, 1),
    ("MeanAbsolutePercentageError", {}, 1),
    ("SymmetricMeanAbsolutePercentageError", {}, 1),
    ("R2Score", {}, 1),
    ("R2Score", {"adjusted": 3}, 1),
    ("R2Score", {"num_outputs": 3, "multioutput": "raw_values"}, 3),
    ("R2Score", {"num_outputs": 3, "multioutput": "uniform_average"}, 3),
    ("R2Score", {"num_outputs": 3, "multioutput": "variance_weighted", "adjusted": 2}, 3),
    ("ExplainedVariance", {}, 1),
    ("ExplainedVariance", {"multioutput": "raw_values"}, 3),
    ("ExplainedVariance", {"multioutput": "variance_weighted"}, 3),
    ("PearsonCorrCoef", {}, 1),
    ("SpearmanCorrCoef", {}, 1),
    ("SpearmanCorrCoef", {"buffer_capacity": 128}, 1),
    ("CosineSimilarity", {}, 6),
    ("CosineSimilarity", {"reduction": "mean"}, 6),
    ("CosineSimilarity", {"reduction": "none"}, 6),
    ("TweedieDevianceScore", {}, 1),
    ("TweedieDevianceScore", {"power": 1.0}, 1),
    ("TweedieDevianceScore", {"power": 1.5}, 1),
    ("TweedieDevianceScore", {"power": 2.0}, 1),
    ("TweedieDevianceScore", {"power": 3.0}, 1),
]


@pytest.mark.parametrize("name,kwargs,width", MODULES, ids=[f"{n}-{k}" for n, k, _ in MODULES])
def test_modules_stream_like_jax(name, kwargs, width):
    port_m, jax_m = _make(name, **kwargs)
    _run_both(port_m, jax_m, _batches(seed=len(name) + width, width=width))


@pytest.mark.parametrize("buffer_capacity", [None, 128])
def test_spearman_with_ties_streams_like_jax(buffer_capacity):
    port_m, jax_m = _make("SpearmanCorrCoef", buffer_capacity=buffer_capacity)
    batches = _batches(seed=7, ties=True)
    assert len(np.unique(np.concatenate([t for _, t in batches]))) < 20  # many ties
    _run_both(port_m, jax_m, batches)


def test_spearman_buffer_overflow_raises():
    port_m, _ = _make("SpearmanCorrCoef", buffer_capacity=50)
    for preds, target in _batches(seed=8, n_batches=2):
        port_m.update(torch.from_numpy(preds), torch.from_numpy(target))
    with pytest.raises(ValueError, match="buffer_capacity exceeded"):
        port_m.compute()


def test_spearman_warns_with_the_jax_text():
    with pytest.warns(UserWarning) as port_record:
        mt.SpearmanCorrCoef(device="cpu")
    with pytest.warns(UserWarning) as jax_record:
        mj.SpearmanCorrCoef()
    assert str(port_record[0].message) == str(jax_record[0].message)


FUNCTIONALS = [
    ("mean_squared_error", {}, 1),
    ("mean_squared_error", {"squared": False}, 1),
    ("mean_absolute_error", {}, 1),
    ("mean_squared_log_error", {}, 1),
    ("mean_absolute_percentage_error", {}, 1),
    ("symmetric_mean_absolute_percentage_error", {}, 1),
    ("r2_score", {}, 1),
    ("r2_score", {"adjusted": 5}, 1),
    ("r2_score", {"multioutput": "raw_values"}, 3),
    ("r2_score", {"multioutput": "variance_weighted"}, 3),
    ("explained_variance", {}, 1),
    ("explained_variance", {"multioutput": "raw_values"}, 3),
    ("explained_variance", {"multioutput": "variance_weighted"}, 3),
    ("pearson_corrcoef", {}, 1),
    ("spearman_corrcoef", {}, 1),
    ("cosine_similarity", {}, 6),
    ("cosine_similarity", {"reduction": "mean"}, 6),
    ("cosine_similarity", {"reduction": None}, 6),
    ("tweedie_deviance_score", {"power": 0.0}, 1),
    ("tweedie_deviance_score", {"power": 1.0}, 1),
    ("tweedie_deviance_score", {"power": 1.5}, 1),
    ("tweedie_deviance_score", {"power": 2.0}, 1),
    ("tweedie_deviance_score", {"power": 3.0}, 1),
]


@pytest.mark.parametrize("name,kwargs,width", FUNCTIONALS, ids=[f"{n}-{k}" for n, k, _ in FUNCTIONALS])
def test_functionals_match_jax(name, kwargs, width):
    preds, target = _batches(seed=len(name), width=width, n_batches=1)[0]
    got = getattr(ft, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    _assert_close(got, getattr(fj, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs))


@pytest.mark.parametrize("name", ["mean_squared_error", "pearson_corrcoef", "r2_score", "spearman_corrcoef"])
def test_functionals_take_float64_like_jax(name):
    preds, target = (a.astype(np.float64) for a in _batches(seed=11, n_batches=1)[0])
    got = getattr(ft, name)(torch.from_numpy(preds), torch.from_numpy(target))
    want = np.asarray(getattr(fj, name)(jnp.asarray(preds), jnp.asarray(target)))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)


def _error_of(fn, *args, **kwargs):
    with pytest.raises(Exception) as err:
        fn(*args, **kwargs)
    return type(err.value), str(err.value)


TWEEDIE_DOMAIN = [
    (1.0, [1.0, 0.0], [1.0, 1.0]),
    (1.0, [1.0, 1.0], [-1.0, 1.0]),
    (2.0, [1.0, 1.0], [0.0, 1.0]),
    (-1.0, [0.0, 1.0], [1.0, 1.0]),
    (1.5, [1.0, 1.0], [-0.5, 1.0]),
    (3.0, [1.0, -2.0], [1.0, 1.0]),
    (0.5, [1.0, 1.0], [1.0, 1.0]),
]


@pytest.mark.parametrize("power,preds,target", TWEEDIE_DOMAIN)
def test_tweedie_domain_errors_match_jax(power, preds, target):
    p, t = np.array(preds, np.float32), np.array(target, np.float32)
    got = _error_of(ft.tweedie_deviance_score, torch.from_numpy(p), torch.from_numpy(t), power=power)
    assert got == _error_of(fj.tweedie_deviance_score, jnp.asarray(p), jnp.asarray(t), power=power)
    assert got[0] is ValueError


def test_tweedie_module_refuses_an_undefined_power():
    assert _error_of(mt.TweedieDevianceScore, power=0.5, device="cpu") == _error_of(mj.TweedieDevianceScore, power=0.5)


ERROR_CASES = [
    ("mean_squared_error", (np.zeros(3), np.zeros(4)), {}),
    ("r2_score", (np.zeros((3, 2, 2)), np.zeros((3, 2, 2))), {}),
    ("r2_score", (np.zeros(1), np.zeros(1)), {}),
    ("r2_score", (np.arange(4.0), np.arange(4.0) + 1), {"multioutput": "bogus"}),
    ("r2_score", (np.arange(4.0), np.arange(4.0) + 1), {"adjusted": -1}),
    ("explained_variance", (np.zeros(3), np.zeros(3)), {"multioutput": "bogus"}),
    ("pearson_corrcoef", (np.zeros((3, 2)), np.zeros((3, 2))), {}),
    ("spearman_corrcoef", (np.zeros(3), np.zeros(3, np.float32)), {}),
    ("spearman_corrcoef", (np.zeros((3, 2)), np.zeros((3, 2))), {}),
    ("cosine_similarity", (np.ones((3, 2)), np.ones((3, 2))), {"reduction": "max"}),
]


@pytest.mark.parametrize("name,args,kwargs", ERROR_CASES)
def test_error_texts_match_jax(name, args, kwargs):
    """The same exception type and text (dtypes are named as each framework names them)."""
    kind, text = _error_of(getattr(ft, name), *(torch.from_numpy(a) for a in args), **kwargs)
    assert (kind, text.replace("torch.", "")) == _error_of(getattr(fj, name), *(jnp.asarray(a) for a in args), **kwargs)


@pytest.mark.parametrize(
    "adjusted,n,message",
    [
        (5, 5, "More independent regressions than data points"),
        (4, 5, "Division by zero in adjusted r2 score"),
    ],
)
def test_r2_adjusted_fallbacks_warn_like_jax(adjusted, n, message):
    preds, target = _batches(seed=12, n_batches=1)[0]
    preds, target = preds[:n], target[:n]
    with pytest.warns(UserWarning, match=message):
        got = ft.r2_score(torch.from_numpy(preds), torch.from_numpy(target), adjusted=adjusted)
    with pytest.warns(UserWarning, match=message):
        want = fj.r2_score(jnp.asarray(preds), jnp.asarray(target), adjusted=adjusted)
    _assert_close(got, want)
    _assert_close(got, ft.r2_score(torch.from_numpy(preds), torch.from_numpy(target)))  # the plain score


def test_pearson_merges_stacked_replica_states_like_one_stream():
    """Two replicas' states, stacked as a sync stacks ``dist_reduce_fx=None``
    states, compute what one stream over both gives, in both packages."""
    batches = _batches(seed=13, n_batches=4)
    port_a, jax_a = _make("PearsonCorrCoef")
    port_b, jax_b = _make("PearsonCorrCoef")
    port_all, jax_all = _make("PearsonCorrCoef")
    for i, (preds, target) in enumerate(batches):
        for port_m, jax_m in ((port_a, jax_a) if i < 2 else (port_b, jax_b), (port_all, jax_all)):
            port_m.update(torch.from_numpy(preds), torch.from_numpy(target))
            jax_m.update(jnp.asarray(preds), jnp.asarray(target))
    names = ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")
    port_stacked = {k: torch.stack([getattr(port_a, k), getattr(port_b, k)]) for k in names}
    jax_stacked = {k: jnp.stack([getattr(jax_a, k), getattr(jax_b, k)]) for k in names}
    merged = port_all.compute_state(port_stacked)
    _assert_close(merged, jax_all.compute_state(jax_stacked))
    _assert_close(merged, port_all.compute())
    _assert_close(merged, jax_all.compute())


@pytest.mark.parametrize(
    "name,kwargs",
    [("MeanSquaredError", {"compensated": True}), ("PearsonCorrCoef", {}), ("SpearmanCorrCoef", {})],
)
def test_state_carries_across_from_jax_mid_stream(name, kwargs):
    """JAX updates batches 1-2; the port takes its state and updates batch
    3; the result equals JAX over all three."""
    batches = _batches(seed=14)
    port_m, jax_m = _make(name, **kwargs)
    for preds, target in batches[:2]:
        jax_m.update(jnp.asarray(preds), jnp.asarray(target))
    jax_m.persistent(True)
    port_m.persistent(True)
    result = port_m.load_state_dict(mt.state_from_jax(jax_m.state_dict()))
    assert not result.missing_keys and not result.unexpected_keys
    preds, target = batches[2]
    port_m.update(torch.from_numpy(preds), torch.from_numpy(target))
    jax_m.update(jnp.asarray(preds), jnp.asarray(target))
    _assert_close(port_m.compute(), jax_m.compute())


def test_compensated_sum_keeps_what_a_plain_float32_sum_drops():
    """Many small squared errors after one large one: the Kahan carry keeps
    the small ones, as the JAX package's ``compensated=True`` does."""
    port_plain, _ = _make("MeanSquaredError")
    port_comp, jax_comp = _make("MeanSquaredError", compensated=True)
    big = (np.array([4096.0], np.float32), np.zeros(1, np.float32))
    small = (np.full(1, 0.5, np.float32), np.zeros(1, np.float32))  # 0.25 is below half an ulp of 4096²
    for preds, target in [big] + [small] * 2000:
        for m in (port_plain, port_comp):
            m.update(torch.from_numpy(preds), torch.from_numpy(target))
        jax_comp.update(jnp.asarray(preds), jnp.asarray(target))
    exact = (4096.0**2 + 2000 * 0.25) / 2001
    assert abs(float(port_comp.compute()) - exact) < abs(float(port_plain.compute()) - exact)
    np.testing.assert_allclose(float(port_comp.compute()), exact, rtol=1e-7)
    _assert_close(port_comp.compute(), jax_comp.compute())

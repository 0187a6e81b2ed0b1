"""The port's aggregators (``MaxMetric``, ``MinMetric``, ``SumMetric``,
``CatMetric``, ``MeanMetric``) against ``metrics_tpu`` on the same numpy
batches, under every ``nan_strategy`` and with and without ``compensated``;
and ``astype``/``half`` with the dtype after ``reset()``.

The JAX side keeps float64 states (x64 lane) where the port keeps float32,
so running values agree within 1e-5 relative (float sums); concatenated
values exactly.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mj
import metrics_tpu_torch as mt
from metrics_tpu_torch.obs.warn import reset_warn_once

RTOL_SUM = 1e-5
STRATEGIES = ["error", "warn", "ignore", "disable", 0.5]
CASES = [
    (name, strategy, compensated)
    for name in ("MaxMetric", "MinMetric", "SumMetric", "CatMetric", "MeanMetric")
    for strategy in STRATEGIES
    for compensated in ((False, True) if name in ("SumMetric", "MeanMetric") else (False,))
]


def _stream(seed: int = 0):
    """(value, weight) batches: 1-D, 2-D and scalar values, NaN in some
    values and in one weight, and ±inf as data."""
    rng = np.random.default_rng(seed)
    v = [rng.standard_normal(6).astype(np.float32) for _ in range(3)]
    v[1][2] = np.nan
    m2 = rng.standard_normal((3, 4)).astype(np.float32)
    m2[0, 1] = np.nan
    w = rng.random(6).astype(np.float32)
    w_nan = w.copy()
    w_nan[4] = np.nan
    inf = np.array([np.inf, -1.5, 2.0], np.float32)
    return [(v[0], w), (v[1], w), (m2, 1.0), (np.float32(3.25), 2.0), (v[2], w_nan), (inf, 1.0)]


def _kwargs(name, strategy, compensated):
    kw = {"nan_strategy": strategy}
    if compensated:
        kw["compensated"] = True
    return kw


def _call(metric, fn, value, weight, as_array, mean: bool):
    args = (as_array(value),) + ((as_array(np.asarray(weight, np.float32)),) if mean else ())
    return getattr(metric, fn)(*args) if fn == "update" else metric(*args)


def _assert_close(got, want, name: str) -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if name == "CatMetric":
        np.testing.assert_array_equal(got, want.astype(got.dtype))
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL_SUM, atol=0)


@pytest.mark.parametrize("name,strategy,compensated", CASES, ids=[f"{n}-{s}-{'kahan' if c else 'plain'}" for n, s, c in CASES])
def test_aggregator_matches_jax(name, strategy, compensated):
    kw = _kwargs(name, strategy, compensated)
    jax_m, port_m = getattr(mj, name)(**kw), getattr(mt, name)(device="cpu", **kw)
    mean = name == "MeanMetric"
    for i, (value, weight) in enumerate(_stream()):
        if name == "CatMetric" and np.ndim(value) == 2:
            value = value.reshape(-1)  # a buffer of 1-D and 2-D values concatenates in neither package
        fn = "forward" if i % 2 == 0 else "update"
        has_nan = np.isnan(value).any() or (mean and np.isnan(weight).any())
        if strategy == "error" and has_nan:
            # raises in both, and the accumulated state stays as it was
            with pytest.raises(RuntimeError, match="Encountered `nan` values"):
                _call(jax_m, fn, value, weight, jnp.asarray, mean)
            with pytest.raises(RuntimeError, match="Encountered `nan` values"):
                _call(port_m, fn, value, weight, torch.from_numpy, mean)
            continue
        reset_warn_once()
        with warnings.catch_warnings(record=True) as port_warnings:
            warnings.simplefilter("always")
            got = _call(port_m, fn, np.array(value), weight, lambda x: torch.from_numpy(np.asarray(x)), mean)
        want = _call(jax_m, fn, value, weight, jnp.asarray, mean)
        warned = any("Will be removed" in str(w.message) for w in port_warnings)
        assert warned == (strategy == "warn" and bool(has_nan))
        if fn == "forward":
            _assert_close(got, want, name)
    _assert_close(port_m.compute(), jax_m.compute(), name)
    port_m.reset()
    jax_m.reset()
    value, weight = _stream()[0]
    _call(port_m, "update", value, weight, torch.from_numpy, mean)
    _call(jax_m, "update", value, weight, jnp.asarray, mean)
    _assert_close(port_m.compute(), jax_m.compute(), name)


def test_nan_strategy_is_checked_like_jax():
    for pkg, kw in ((mj, {}), (mt, {"device": "cpu"})):
        with pytest.raises(ValueError, match="nan_strategy"):
            pkg.MeanMetric(nan_strategy="drop", **kw)


@pytest.mark.parametrize("cast", ["half", "bfloat16", "double", "float"])
def test_astype_casts_current_float_states_and_reset_restores_the_default(cast):
    """``half()`` and the others cast the current floating states only, as
    in the JAX package: integer states keep their dtype, and ``reset()``
    brings back the registered dtype."""
    dtype = {"half": torch.float16, "bfloat16": torch.bfloat16, "double": torch.float64, "float": torch.float32}[cast]
    port_mean, jax_mean = mt.MeanMetric(device="cpu"), mj.MeanMetric()
    port_acc, jax_acc = mt.Accuracy(num_classes=3, device="cpu"), mj.Accuracy(num_classes=3)
    port_mean.update(torch.tensor([1.0, 2.0]))
    jax_mean.update(jnp.asarray([1.0, 2.0]))
    for port, jax_m in ((port_mean, jax_mean), (port_acc, jax_acc)):
        assert getattr(port, cast)() is port
        getattr(jax_m, cast)()
    assert port_mean.value.dtype == dtype and port_mean.weight.dtype == dtype
    assert str(jax_mean.value.dtype) == str(dtype).replace("torch.", "")
    assert port_acc.tp.dtype == torch.int64 and jnp.issubdtype(jax_acc.tp.dtype, jnp.integer)
    assert port_mean.compute().dtype == dtype
    for m in (port_mean, jax_mean):
        m.reset()
    assert port_mean.value.dtype == torch.float32  # the registered default's
    assert jax_mean.value.dtype == jnp.asarray(0.0).dtype  # the JAX default's: float64 in the x64 lane
    port_mean.update(torch.tensor([4.0]))
    assert float(port_mean.compute()) == 4.0


def test_collection_astype_and_to_device():
    mc = mt.MetricCollection({"mean": mt.MeanMetric(device="cpu"), "acc": mt.Accuracy(num_classes=3, device="cpu")})
    mc["mean"].update(torch.tensor([1.0, 3.0]))
    assert mc.astype(torch.float64) is mc and mc["mean"].value.dtype == torch.float64
    assert mc.to_device("meta") is mc
    assert mc["mean"].device.type == "meta" and mc["acc"].tp.device.type == "meta"
    mc.reset()
    assert mc["mean"].value.device.type == "meta"

"""The port's image quality metrics without networks against ``metrics_tpu``
on the same seeded numpy images: ``peak_signal_noise_ratio`` and
``PeakSignalNoiseRatio`` in every ``reduction``/``dim``/``data_range``
mode, SSIM and MS-SSIM (functionals and modules), and ``image_gradients``.

Tolerances: PSNR within 1e-6 relative (float32) and 1e-12 (float64); SSIM
and MS-SSIM within 1e-5 absolute in float32 and 1e-10 in float64;
``image_gradients`` exactly.
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

SSIM_ATOL = {np.float32: 1e-5, np.float64: 1e-10}
PSNR_RTOL = {np.float32: 1e-6, np.float64: 1e-12}


def _images(seed: int, shape, dtype=np.float32, noise: float = 0.1):
    rng = np.random.default_rng(seed)
    target = rng.random(shape).astype(dtype)
    preds = np.clip(target + noise * rng.standard_normal(shape), 0, 1).astype(dtype)
    return preds, target


def _close(got, want, rtol: float = 0.0, atol: float = 0.0) -> None:
    g, w = got.detach().cpu().numpy(), np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


PSNR_MODES = [
    {},
    {"data_range": 1.0},
    {"data_range": 2.0, "base": 2.0},
    {"data_range": 1.0, "dim": (1, 2, 3), "reduction": "none"},
    {"data_range": 1.0, "dim": (2, 3), "reduction": "elementwise_mean"},
    {"data_range": 3.0, "dim": 1, "reduction": "sum"},
    {"data_range": 1.0, "dim": ()},
]


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("kwargs", PSNR_MODES, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_psnr_functional_follows_jax(kwargs, dtype):
    preds, target = _images(1, (3, 2, 12, 10), dtype)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = ft.peak_signal_noise_ratio(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
        want = fj.peak_signal_noise_ratio(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    _close(got, want, rtol=PSNR_RTOL[dtype])


def test_psnr_needs_a_data_range_with_dim():
    preds, target = map(torch.from_numpy, _images(2, (2, 1, 4, 4)))
    with pytest.raises(ValueError, match="data_range"):
        ft.peak_signal_noise_ratio(preds, target, dim=1)
    with pytest.raises(ValueError, match="data_range"):
        mt.PeakSignalNoiseRatio(dim=1, device="cpu")


MODULE_MODES = [m for m in PSNR_MODES if m.get("dim") != ()]


@pytest.mark.parametrize("kwargs", MODULE_MODES, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_psnr_module_streams_like_jax(kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        port_m, jax_m = mt.PeakSignalNoiseRatio(device="cpu", **kwargs), mj.PeakSignalNoiseRatio(**kwargs)
        for seed, n in ((3, 4), (4, 4), (5, 3)):
            preds, target = _images(seed, (n, 2, 12, 10), noise=0.05 * seed)
            _close(port_m(torch.from_numpy(preds), torch.from_numpy(target)), jax_m(jnp.asarray(preds), jnp.asarray(target)), rtol=1e-6)
        _close(port_m.compute(), jax_m.compute(), rtol=1e-6)
    # the sums are states the engine runs as a program; the buffered scores are list states
    assert port_m._has_list_state() == ("dim" in kwargs)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
@pytest.mark.parametrize("data_range", [None, 1.0])
def test_ssim_functional_follows_jax(data_range, reduction, dtype):
    preds, target = _images(6, (3, 2, 40, 36), dtype)
    got = ft.structural_similarity_index_measure(torch.from_numpy(preds), torch.from_numpy(target), data_range=data_range, reduction=reduction)
    want = fj.structural_similarity_index_measure(jnp.asarray(preds), jnp.asarray(target), data_range=data_range, reduction=reduction)
    # a sum over the map scales the per-pixel rounding by its element count
    n = preds.size if reduction == "sum" else 1
    _close(got, want, atol=SSIM_ATOL[dtype] * n)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("kernel_size,sigma,k1,k2", [((7, 5), (1.0, 2.0), 0.01, 0.03), ((3, 3), (0.5, 0.5), 0.05, 0.1)])
def test_ssim_window_and_constants_follow_jax(kernel_size, sigma, k1, k2, dtype):
    preds, target = _images(7, (2, 3, 24, 30), dtype)
    kw = dict(kernel_size=kernel_size, sigma=sigma, k1=k1, k2=k2, data_range=1.0)
    got = ft.structural_similarity_index_measure(torch.from_numpy(preds), torch.from_numpy(target), **kw)
    want = fj.structural_similarity_index_measure(jnp.asarray(preds), jnp.asarray(target), **kw)
    _close(got, want, atol=SSIM_ATOL[dtype])


def test_ssim_of_integer_images_follows_jax():
    rng = np.random.default_rng(8)
    target = rng.integers(0, 256, (2, 1, 20, 20))
    preds = np.clip(target + rng.integers(-20, 20, target.shape), 0, 255)
    got = ft.structural_similarity_index_measure(torch.from_numpy(preds), torch.from_numpy(target), data_range=255.0)
    want = fj.structural_similarity_index_measure(jnp.asarray(preds), jnp.asarray(target), data_range=255.0)
    _close(got, want, atol=1e-5)


@pytest.mark.parametrize(
    "bad,match",
    [
        (dict(kernel_size=(4, 5)), "odd positive"),
        (dict(kernel_size=(5,)), "length of two"),
        (dict(sigma=(1.5, -1.0)), "positive number"),
    ],
)
def test_ssim_rejects_what_jax_rejects(bad, match):
    preds, target = _images(9, (1, 1, 16, 16))
    with pytest.raises(ValueError, match=match):
        ft.structural_similarity_index_measure(torch.from_numpy(preds), torch.from_numpy(target), **bad)
    with pytest.raises(ValueError, match=match):
        fj.structural_similarity_index_measure(jnp.asarray(preds), jnp.asarray(target), **bad)
    with pytest.raises(TypeError, match="same data type"):
        ft.structural_similarity_index_measure(torch.from_numpy(preds), torch.from_numpy(target).double())
    with pytest.raises(ValueError, match="BxCxHxW"):
        ft.structural_similarity_index_measure(torch.from_numpy(preds[0]), torch.from_numpy(target[0]))


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("normalize", [None, "relu", "simple"])
@pytest.mark.parametrize("reduction", ["elementwise_mean", "none"])
def test_ms_ssim_functional_follows_jax(reduction, normalize, dtype):
    # a batch of two: the per-image combination of the scales (the JAX package's) shows
    preds, target = _images(10, (2, 3, 192, 176), dtype, noise=0.2)
    kw = dict(data_range=1.0, normalize=normalize, reduction=reduction)
    got = ft.multiscale_structural_similarity_index_measure(torch.from_numpy(preds), torch.from_numpy(target), **kw)
    want = fj.multiscale_structural_similarity_index_measure(jnp.asarray(preds), jnp.asarray(target), **kw)
    _close(got, want, atol=SSIM_ATOL[dtype])


def test_ms_ssim_with_three_scales_and_an_inferred_range_follows_jax():
    preds, target = _images(11, (2, 1, 64, 72))
    kw = dict(kernel_size=(5, 5), betas=(0.3, 0.4, 0.3))
    got = ft.multiscale_structural_similarity_index_measure(torch.from_numpy(preds), torch.from_numpy(target), **kw)
    want = fj.multiscale_structural_similarity_index_measure(jnp.asarray(preds), jnp.asarray(target), **kw)
    _close(got, want, atol=1e-5)


def test_ms_ssim_rejects_small_images_and_bad_arguments():
    preds, target = map(torch.from_numpy, _images(12, (1, 1, 100, 100)))
    with pytest.raises(ValueError, match="larger than"):
        ft.multiscale_structural_similarity_index_measure(preds, target)
    with pytest.raises(ValueError, match="betas"):
        ft.multiscale_structural_similarity_index_measure(preds, target, betas=[0.5, 0.5])
    with pytest.raises(ValueError, match="normalize"):
        ft.multiscale_structural_similarity_index_measure(preds, target, normalize="max")


@pytest.mark.parametrize("module", ["StructuralSimilarityIndexMeasure", "MultiScaleStructuralSimilarityIndexMeasure"])
@pytest.mark.parametrize("data_range", [None, 1.0])
def test_ssim_modules_stream_like_jax(module, data_range):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        port_m = getattr(mt, module)(data_range=data_range, device="cpu")
        jax_m = getattr(mj, module)(data_range=data_range)
        for seed in (13, 14, 15):
            preds, target = _images(seed, (2, 2, 176, 180), noise=0.05 * (seed - 12))
            _close(port_m(torch.from_numpy(preds), torch.from_numpy(target)), jax_m(jnp.asarray(preds), jnp.asarray(target)), atol=1e-5)
        _close(port_m.compute(), jax_m.compute(), atol=1e-5)
    assert len(port_m.preds) == len(port_m.target) == 3


def test_image_gradients_equal_jax():
    img = np.random.default_rng(16).standard_normal((2, 3, 9, 7)).astype(np.float32)
    for got, want in zip(ft.image_gradients(torch.from_numpy(img)), fj.image_gradients(jnp.asarray(img))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(RuntimeError, match="4D"):
        ft.image_gradients(torch.zeros(3, 4))
    with pytest.raises(TypeError):
        ft.image_gradients(np.zeros((1, 1, 2, 2)))

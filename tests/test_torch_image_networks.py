"""The port's InceptionV3 (FID variant) and LPIPS networks against
``metrics_tpu``'s on the same weights and the same seeded numpy images.

The weights cross three ways: ``random_*_params(seed)`` in each package
(the same draws), the JAX tree through ``inception_params_from_jax`` /
``lpips_params_from_jax``, and a ``.npz`` written by the JAX package and
loaded by the port. Tolerances are the JAX package's own network tests':
InceptionV3 taps at rtol 1e-3, atol 2e-3; LPIPS at rtol 1e-4, atol 1e-5;
the TF1 resize at 1e-6 relative. Full-size forwards are few and shared
through module-scoped fixtures.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from metrics_tpu.image.networks import inception as ji
from metrics_tpu.image.networks import lpips as jl
from metrics_tpu_torch.image.networks import inception as ti
from metrics_tpu_torch.image.networks import lpips as tl
from metrics_tpu_torch.image.networks._common import to_nchw
from metrics_tpu_torch.interop import inception_params_from_jax, lpips_params_from_jax

TAPS = ("64", "192", "768", "2048", "logits_unbiased", "logits")
NET_RTOL, NET_ATOL = 1e-3, 2e-3
# every tap less its batch mean, relative to the largest of those: the part of a random-weight
# network's output that differs between images (about 1e-4 of its size), which NET_RTOL cannot see
NET_CENTRED_RTOL = 5e-3
LPIPS_RTOL, LPIPS_ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def jax_params():
    return ji.random_inception_params(seed=7)


@pytest.fixture(scope="module")
def npz_file(jax_params, tmp_path_factory):
    path = tmp_path_factory.mktemp("weights") / "inception.npz"
    ji.save_inception_weights(jax_params, str(path))
    return str(path)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).integers(0, 256, size=(2, 3, 299, 299), dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_taps(jax_params, images):
    x = ji.preprocess_inception_input(jnp.asarray(images), resize_input=False)
    return {k: np.asarray(v) for k, v in ji.inception_v3(jax_params, x, TAPS).items()}


def _port_params(route: str, jax_params, npz_file):
    if route == "seed":
        return ti.random_inception_params(seed=7, device="cpu")
    if route == "from_jax":
        return inception_params_from_jax({m: {n: np.asarray(v) for n, v in g.items()} for m, g in jax_params.items()}, device="cpu")
    return ti.load_inception_weights(npz_file, device="cpu")


@pytest.mark.parametrize("route", ["seed", "from_jax", "npz"])
def test_inception_weights_cross_every_route_unchanged(route, jax_params, npz_file):
    params = _port_params(route, jax_params, npz_file)
    spec = ti.inception_param_spec()
    assert set(params) == set(jax_params) == set(spec)
    for mod, group in jax_params.items():
        for name, value in group.items():
            got = params[mod][name]
            assert tuple(got.shape) == spec[mod][name] and got.dtype == torch.float32
            np.testing.assert_array_equal(ti._to_file_layout(got.numpy()), np.asarray(value), err_msg=f"{mod}.{name}")


@pytest.mark.parametrize("route", ["seed", "npz"])
def test_inception_every_tap_follows_jax(route, jax_params, npz_file, images, jax_taps):
    params = _port_params(route, jax_params, npz_file)
    x = ti.preprocess_inception_input(torch.from_numpy(images), resize_input=False)
    got = ti.inception_v3(params, x, TAPS)
    assert set(got) == set(TAPS)
    for key in TAPS:
        assert tuple(got[key].shape) == jax_taps[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), jax_taps[key], rtol=NET_RTOL, atol=NET_ATOL, err_msg=key)


def _centred_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    got, want = got - got.mean(0), want - want.mean(0)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_inception_centred_taps_follow_jax(images, jax_taps):
    params = ti.random_inception_params(seed=7, device="cpu")
    got = ti.inception_v3(params, ti.preprocess_inception_input(torch.from_numpy(images), resize_input=False), TAPS)
    for key in TAPS:
        assert _centred_err(got[key].numpy(), jax_taps[key]) <= NET_CENTRED_RTOL, key
    # the control: an input normalized as (x - 127.5) / 127.5 passes NET_RTOL but not this bound
    shifted = ti.inception_v3(params, (torch.from_numpy(images).float() - 127.5) / 127.5, ("2048",))["2048"].numpy()
    np.testing.assert_allclose(shifted, jax_taps["2048"], rtol=NET_RTOL, atol=NET_ATOL)
    assert _centred_err(shifted, jax_taps["2048"]) > NET_CENTRED_RTOL


def test_inception_taps_stop_at_the_deepest_requested(jax_params, images, jax_taps):
    params = ti.random_inception_params(seed=7, device="cpu")
    x = ti.preprocess_inception_input(torch.from_numpy(images[:1]), resize_input=False)
    got = ti.inception_v3(params, x, ("64",))
    assert list(got) == ["64"]
    np.testing.assert_allclose(got["64"].numpy(), jax_taps["64"][:1], rtol=NET_RTOL, atol=NET_ATOL)
    with pytest.raises(ValueError, match="Unknown inception features"):
        ti.inception_v3(params, x, ("1000",))


def test_inception_extractor_resizes_like_jax(jax_params):
    img = np.random.default_rng(2).integers(0, 256, size=(1, 3, 32, 32), dtype=np.uint8)
    want = np.asarray(ji.InceptionV3Features(jax_params, "2048")(jnp.asarray(img)))
    ext = ti.InceptionV3Features(ti.random_inception_params(seed=7, device="cpu"), 2048)
    assert ext.feature_dim == 2048 and ext.device == torch.device("cpu")
    got = ext(torch.from_numpy(img))
    assert tuple(got.shape) == (1, 2048)
    np.testing.assert_allclose(got.numpy(), want, rtol=NET_RTOL, atol=NET_ATOL)
    # NHWC input gives the same features
    np.testing.assert_allclose(ext(torch.from_numpy(img).permute(0, 2, 3, 1)).numpy(), got.numpy(), rtol=1e-6, atol=1e-7)


def test_tf1_resize_follows_jax_and_is_not_half_pixel_interpolate():
    x = np.random.default_rng(1).uniform(0, 255, size=(1, 5, 7, 3)).astype(np.float32)
    want = np.asarray(ji.resize_bilinear_tf1(jnp.asarray(x), (11, 4)))
    x_t = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = ti.resize_bilinear_tf1(x_t, (11, 4)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    half_pixel = F.interpolate(x_t, size=(11, 4), mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy()
    assert np.abs(half_pixel - want).max() > 1.0


def test_layout_rule_and_shape_errors():
    x = torch.zeros(2, 3, 5, 3)  # ambiguous: NCHW, as every reference caller means
    assert to_nchw(x) is x
    assert tuple(to_nchw(torch.zeros(2, 5, 4, 3)).shape) == (2, 3, 5, 4)
    with pytest.raises(ValueError, match="4D"):
        to_nchw(torch.zeros(3, 5, 5))
    with pytest.raises(ValueError, match="channel axis"):
        to_nchw(torch.zeros(2, 4, 5, 5))


def test_missing_and_malformed_weights_raise(monkeypatch, tmp_path, jax_params):
    monkeypatch.delenv(ti.ENV_WEIGHTS_VAR, raising=False)
    monkeypatch.delenv(tl.ENV_WEIGHTS_VAR, raising=False)
    with pytest.raises(ModuleNotFoundError, match=ti.ENV_WEIGHTS_VAR):
        ti.resolve_inception_extractor(2048, None, device="cpu")
    with pytest.raises(ModuleNotFoundError, match=tl.ENV_WEIGHTS_VAR):
        tl.resolve_lpips_network("vgg", None, device="cpu")
    with pytest.raises(ValueError, match="must be one of"):
        ti.resolve_inception_extractor(1000, None, device="cpu")
    params = ti.random_inception_params(seed=7, device="cpu")
    params["fc"]["kernel"] = params["fc"]["kernel"][:, :10]
    with pytest.raises(ValueError, match="fc.kernel has shape"):
        ti._validate_params(params)
    bad = tmp_path / "bad.npz"
    np.savez(str(bad), nodot=np.zeros(3))
    with pytest.raises(ValueError, match="Malformed"):
        ti.load_inception_weights(str(bad), device="cpu")
    missing = tmp_path / "missing.npz"
    np.savez(str(missing), **{"fc.kernel": np.zeros((2048, 1008), np.float32)})
    with pytest.raises(ValueError, match="missing parameter groups"):
        ti.load_inception_weights(str(missing), device="cpu")
    alex = lpips_params_from_jax(jl.random_lpips_params("alex", seed=1), "alex", device="cpu")
    with pytest.raises(ValueError, match="missing parameter groups"):
        tl._validate_params(alex, "vgg")


def test_resolve_caches_per_device_and_save_round_trips(npz_file, tmp_path):
    ti.clear_inception_extractor_cache()
    a = ti.resolve_inception_extractor(64, npz_file, device="cpu")
    assert ti.resolve_inception_extractor(64, npz_file, device="cpu") is a
    assert ti.resolve_inception_extractor(192, npz_file, device="cpu") is not a
    out = tmp_path / "again"
    ti.save_inception_weights(a.params, str(out))  # suffix-less: written as again.npz
    back = ji.load_inception_weights(str(out))
    np.testing.assert_array_equal(np.asarray(back["Mixed_7c.branch_pool"]["kernel"]), ti._to_file_layout(a.params["Mixed_7c.branch_pool"]["kernel"].numpy()))
    ti.clear_inception_extractor_cache()


@pytest.mark.parametrize("net", ["vgg", "alex"])
def test_lpips_follows_jax(net, tmp_path):
    jax_params = jl.random_lpips_params(net, seed=11)
    rng = np.random.default_rng(0)
    img1 = rng.uniform(-1, 1, size=(2, 3, 64, 64)).astype(np.float32)
    img2 = rng.uniform(-1, 1, size=(2, 3, 64, 64)).astype(np.float32)
    want = np.asarray(jl.LPIPSNetwork(jax_params, net)(jnp.asarray(img1), jnp.asarray(img2)))
    path = tmp_path / f"{net}.npz"
    jl.save_lpips_weights(jax_params, str(path))
    routes = {
        "seed": tl.random_lpips_params(net, seed=11, device="cpu"),
        "from_jax": lpips_params_from_jax(jax_params, net, device="cpu"),
        "npz": tl.load_lpips_weights(str(path), net, device="cpu"),
    }
    for route, params in routes.items():
        got = tl.LPIPSNetwork(params, net)(torch.from_numpy(img1), torch.from_numpy(img2))
        assert tuple(got.shape) == (2,)
        np.testing.assert_allclose(got.numpy(), want, rtol=LPIPS_RTOL, atol=LPIPS_ATOL, err_msg=route)
    functional = tl.lpips_distance(routes["seed"], torch.from_numpy(img1), torch.from_numpy(img2), net)
    np.testing.assert_allclose(functional.numpy(), want, rtol=LPIPS_RTOL, atol=LPIPS_ATOL)
    same = tl.LPIPSNetwork(routes["seed"], net)(torch.from_numpy(img1), torch.from_numpy(img1))
    np.testing.assert_allclose(same.numpy(), 0.0, atol=1e-6)
    with pytest.raises(ValueError, match="'vgg' or 'alex'"):
        tl.LPIPSNetwork(routes["seed"], "squeeze")

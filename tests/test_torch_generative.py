"""The port's FID, KID, IS and LPIPS metrics, the Newton–Schulz square root
and the encoder runtime and stream, against ``metrics_tpu`` on the same
seeded numpy inputs.

The metrics share one small extractor, a fixed linear map of flattened
``[N, 3, 8, 8]`` images to 8 features, computed in float64 and rounded to
float32 by each package, so both packages see the same features and the
comparison is of the metrics alone (the networks are held against each
other in ``test_torch_image_networks.py``). One case takes the default
InceptionV3 extractor from a shared ``.npz``.

Tolerances: FID within 1e-6 relative (eigh, buffered, Newton–Schulz
against JAX's Newton–Schulz, ``update_stream``); KID and IS within 1e-5;
LPIPS within 1e-5 relative; encoder carries within 1e-6 relative and
health counters exactly.
"""
import copy
import pickle
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mj
import metrics_tpu.deprecated as dj
import metrics_tpu_torch as mt
import metrics_tpu_torch.deprecated as dt
from metrics_tpu import engine as jengine
from metrics_tpu.encoders import encode_stream as j_encode_stream
from metrics_tpu.encoders import reset_encoder_stats as j_reset_encoder_stats
from metrics_tpu.image import fid as jfid
from metrics_tpu.image.networks import inception as ji
from metrics_tpu.image.networks import lpips as jl
from metrics_tpu.sharding import linalg as jlinalg
from metrics_tpu_torch import engine as tengine
from metrics_tpu_torch.encoders import ShardedEncoder, encode_stream, encoder_stats, reset_encoder_stats
from metrics_tpu_torch.image import fid as tfid
from metrics_tpu_torch.image.networks import lpips as tl
from metrics_tpu_torch.interop import lpips_params_from_jax, state_from_jax, state_to_jax
from metrics_tpu_torch.sharding import linalg as tlinalg
from metrics_tpu_torch.utils.exceptions import MetricsUserError, NumericalHealthError

D = 8
W = np.random.default_rng(5).standard_normal((3 * 8 * 8, D)) / 8.0


def jax_extractor(imgs):
    x = jnp.asarray(imgs, jnp.float64).reshape(imgs.shape[0], -1)
    return (x @ jnp.asarray(W)).astype(jnp.float32)


def port_extractor(imgs):
    x = torch.as_tensor(imgs).to(torch.float64).reshape(imgs.shape[0], -1)
    return (x @ torch.from_numpy(W)).to(torch.float32)


def _images(seed: int, n: int, shift: float = 0.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.random((n, 3, 8, 8)) + shift * rng.random((1, 3, 8, 8))).astype(np.float32)


REAL = [_images(1, 24), _images(2, 24), _images(3, 13)]
FAKE = [_images(4, 24, 0.5), _images(5, 20, 0.5)]


def _feed(m, to, real=REAL, fake=FAKE):
    for b in real:
        m.update(to(b), real=True)
    for b in fake:
        m.update(to(b), real=False)
    return m


def _jax(x):
    return jnp.asarray(x)


def _rel(got, want, rtol):
    got = np.asarray(got.detach().cpu().numpy() if hasattr(got, "detach") else got, np.float64)
    np.testing.assert_allclose(got, np.asarray(want, np.float64), rtol=rtol)


@pytest.fixture(autouse=True)
def _fresh_caches():
    tengine.clear_cache()
    jengine.clear_cache()
    reset_encoder_stats()
    j_reset_encoder_stats()
    yield


# --------------------------------------------------------------------- FID
@pytest.mark.parametrize(
    "kwargs",
    [{"feature_dim": D}, {}, {"feature_dim": D, "matrix_sqrt": "newton_schulz"}, {"feature_dim": D, "matrix_sqrt": "newton_schulz", "sqrt_iters": 20}],
    ids=["streaming-eigh", "buffered-eigh", "streaming-newton_schulz", "newton_schulz-20-iters"],
)
def test_fid_follows_jax(kwargs):
    port = _feed(mt.FrechetInceptionDistance(feature=port_extractor, device="cpu", **kwargs), torch.from_numpy)
    jax_m = _feed(mj.FrechetInceptionDistance(feature=jax_extractor, **kwargs), _jax)
    got, want = port.compute(), jax_m.compute()
    assert got.dtype == torch.float32 and got.shape == ()
    _rel(got, want, 1e-6)
    if "feature_dim" in kwargs:
        assert port.real_outer.dtype == torch.float64 and int(port.real_n) == 61
        for name in ("real_sum", "real_outer", "fake_sum", "fake_outer"):
            np.testing.assert_allclose(getattr(port, name).numpy(), np.asarray(getattr(jax_m, name)), rtol=1e-12)


def test_newton_schulz_functions_follow_jax_and_eigh():
    rng = np.random.default_rng(9)
    a = rng.standard_normal((40, 6))
    b = rng.standard_normal((40, 6)) + 0.3
    mats = [np.cov(a.T), np.cov(b.T)]
    mus = [a.mean(0), b.mean(0)]
    want = float(jlinalg.fid_from_moments(jnp.asarray(mus[0]), jnp.asarray(mats[0]), jnp.asarray(mus[1]), jnp.asarray(mats[1])))
    got = tlinalg.fid_from_moments(*(torch.from_numpy(x) for x in (mus[0], mats[0], mus[1], mats[1])))
    _rel(got, want, 1e-9)
    _rel(got, tfid._compute_fid(mus[0], mats[0], mus[1], mats[1]), tlinalg.NEWTON_SCHULZ_FID_RTOL)
    root = tlinalg.newton_schulz_sqrtm(torch.from_numpy(mats[0]))
    np.testing.assert_allclose((root @ root).numpy(), mats[0], rtol=1e-4, atol=1e-5)
    s = torch.from_numpy(a.sum(0))
    mu, cov = tlinalg.covariance_from_sums(s, torch.from_numpy(a.T @ a), torch.tensor(40))
    np.testing.assert_allclose(mu.numpy(), mus[0], rtol=1e-12)
    np.testing.assert_allclose(cov.numpy(), mats[0], rtol=1e-10, atol=1e-12)


def test_fid_eps_retry_follows_jax(monkeypatch):
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((30, 5)), rng.standard_normal((30, 5))
    args = (a.mean(0), np.cov(a.T), b.mean(0), np.cov(b.T))
    real_eigvalsh = np.linalg.eigvalsh

    def run(fn):
        calls = []

        def first_call_nan(m):
            calls.append(1)
            vals = real_eigvalsh(m)
            return vals * np.nan if len(calls) == 1 else vals

        monkeypatch.setattr(np.linalg, "eigvalsh", first_call_nan)
        try:
            return fn(*args), len(calls)
        finally:
            monkeypatch.setattr(np.linalg, "eigvalsh", real_eigvalsh)

    (got, n_port), (want, n_jax) = run(tfid._compute_fid), run(jfid._compute_fid)
    assert n_port == n_jax == 2  # the first eigvalsh was non-finite: one retry with the offset
    _rel(got, want, 1e-12)
    assert got != tfid._compute_fid(*args)  # the retry added eps to both diagonals


def test_fid_needs_two_samples_and_rejects_sharding():
    fid = mt.FrechetInceptionDistance(feature=port_extractor, feature_dim=D, device="cpu")
    fid.update(torch.from_numpy(REAL[0][:1]), real=True)
    fid.update(torch.from_numpy(FAKE[0]), real=False)
    with pytest.raises(MetricsUserError, match="at least two samples"):
        fid.compute()
    buffered = mt.FrechetInceptionDistance(feature=port_extractor, device="cpu")
    buffered.update(torch.from_numpy(REAL[0][:1]), real=True)
    buffered.update(torch.from_numpy(FAKE[0]), real=False)
    with pytest.raises(MetricsUserError, match="at least two samples"):
        buffered.compute()
    # an axis-name encoder_sharding shards the built-in network only (a mesh: test_torch_encoder_mesh.py)
    with pytest.raises(MetricsUserError, match="built-in InceptionV3"):
        mt.FrechetInceptionDistance(feature=port_extractor, feature_dim=D, device="cpu", encoder_sharding="mp")
    assert mt.FrechetInceptionDistance(
        feature=port_extractor, feature_dim=D, device="cpu", feature_sharding="mp"
    )._state_shardings["real_outer"] == ("mp",)
    with pytest.raises(MetricsUserError, match="need `feature_dim`"):
        mt.FrechetInceptionDistance(feature=port_extractor, matrix_sqrt="newton_schulz", device="cpu")
    with pytest.raises(ValueError, match="matrix_sqrt"):
        mt.FrechetInceptionDistance(feature=port_extractor, feature_dim=D, matrix_sqrt="svd", device="cpu")
    with pytest.raises(MetricsUserError, match="expected feature_dim=4"):
        mt.FrechetInceptionDistance(feature=port_extractor, feature_dim=4, device="cpu").update(torch.from_numpy(REAL[0]))
    with pytest.raises(MetricsUserError, match=r"\[N, d\]"):
        mt.FrechetInceptionDistance(feature=lambda x: x, feature_dim=4, device="cpu").update(torch.from_numpy(REAL[0]))
    with pytest.raises(TypeError, match="unknown input"):
        mt.FrechetInceptionDistance(feature="2048", device="cpu")


def test_fid_state_dict_crosses_both_ways():
    jax_m = mj.FrechetInceptionDistance(feature=jax_extractor, feature_dim=D)
    jax_m.update(_jax(REAL[0]), real=True)
    jax_m.update(_jax(FAKE[0]), real=False)
    jax_m.persistent(True)
    port = mt.FrechetInceptionDistance(feature=port_extractor, feature_dim=D, device="cpu")
    port.persistent(True)
    port.load_state_dict(state_from_jax(jax_m.state_dict()))
    for m, to in ((port, torch.from_numpy), (jax_m, _jax)):
        _feed(m, to, REAL[1:], FAKE[1:])
    _rel(port.compute(), jax_m.compute(), 1e-6)
    back = mj.FrechetInceptionDistance(feature=jax_extractor, feature_dim=D)
    back.persistent(True)
    saved = port.state_dict()
    assert set(saved) == {f"{p}_{s}" for p in ("real", "fake") for s in ("sum", "sum_c", "outer", "outer_c", "n")}
    back.load_state_dict(state_to_jax(saved))
    _rel(port.compute(), back.compute(), 1e-6)


def _stream_batches():
    return [REAL[0], REAL[1], REAL[2]]  # 24, 24 and a ragged 13 (bucket 16)


def test_fid_update_stream_equals_update_and_jax():
    port_u = _feed(mt.FrechetInceptionDistance(feature=port_extractor, feature_dim=D, device="cpu"), torch.from_numpy, fake=FAKE)
    port_s = mt.FrechetInceptionDistance(feature=port_extractor, feature_dim=D, device="cpu")
    result = port_s.update_stream([torch.from_numpy(b) for b in _stream_batches()], real=True)
    port_s.update_stream(FAKE, real=False)  # numpy batches are staged too
    assert (result.chunks, result.rows, result.rows_screened) == (3, 61, 0)
    assert port_s._update_count == 5
    jax_s = mj.FrechetInceptionDistance(feature=jax_extractor, feature_dim=D)
    jax_s.update_stream(_stream_batches(), real=True)
    jax_s.update_stream(FAKE, real=False)
    for name in ("real_sum", "real_outer", "real_n", "fake_sum", "fake_outer", "fake_n"):
        np.testing.assert_allclose(getattr(port_s, name).numpy(), getattr(port_u, name).numpy(), rtol=1e-12, err_msg=name)
        np.testing.assert_allclose(getattr(port_s, name).numpy(), np.asarray(getattr(jax_s, name)), rtol=1e-12, err_msg=name)
    _rel(port_s.compute(), port_u.compute(), 1e-6)
    _rel(port_s.compute(), jax_s.compute(), 1e-6)
    # one fused program per bucket signature: 24 and 20 rows share the 32-row bucket, 13 has 16
    summary = tengine.cache_summary()["by_kind"]["encode"]
    assert summary["compiles"] == 2 and summary["cache_hits"] == 3
    stats = encoder_stats()
    assert stats["fused_calls"] == 5 and stats["stream_chunks"] == 5 and stats["rows_encoded"] == 105
    assert stats["bucketed_dispatches"] == 5 and stats["placements"] == 0
    # the metric pickles and copies after a stream (the wrapper is rebuilt)
    for clone in (copy.deepcopy(port_s), pickle.loads(pickle.dumps(port_s))):
        clone._computed = None
        _rel(clone.compute(), port_s.compute(), 0)
    with pytest.raises(MetricsUserError, match="needs `feature_dim`"):
        mt.FrechetInceptionDistance(feature=port_extractor, device="cpu").update_stream(FAKE)


def _contaminated(seed: int):
    rng = np.random.default_rng(seed)
    clean, bad = rng.random((8, 3, 8, 8)).astype(np.float32), rng.random((8, 3, 8, 8)).astype(np.float32)
    bad[2, 0, 3, 3] = np.nan
    bad[5, 1, 0, 0] = np.inf
    bad[5, 2, 0, 0] = np.nan
    return [clean, bad, rng.random((5, 3, 8, 8)).astype(np.float32)]


@pytest.mark.parametrize("policy", ["mask", "skip"])
def test_fid_stream_screening_follows_jax(policy):
    batches = _contaminated(11)
    port = mt.FrechetInceptionDistance(feature=port_extractor, feature_dim=D, on_bad_input=policy, device="cpu")
    jax_m = mj.FrechetInceptionDistance(feature=jax_extractor, feature_dim=D, on_bad_input=policy)
    r_port = port.update_stream([torch.from_numpy(b) for b in batches])
    r_jax = jax_m.update_stream(batches)
    assert (r_port.chunks, r_port.rows, r_port.rows_screened, r_port.batches_quarantined) == (
        r_jax.chunks, r_jax.rows, r_jax.rows_screened, r_jax.batches_quarantined
    )
    for name in ("real_sum", "real_outer", "real_n"):
        np.testing.assert_allclose(getattr(port, name).numpy(), np.asarray(getattr(jax_m, name)), rtol=1e-12, err_msg=name)
    assert port.health_report() == jax_m.health_report()
    want = {"mask": (3, 19, 2, 0), "skip": (2, 13, 2, 1)}[policy]
    assert (r_port.chunks, r_port.rows, r_port.rows_screened, r_port.batches_quarantined) == want


def test_fid_default_inception_extractor_from_a_shared_npz(tmp_path):
    path = tmp_path / "inception.npz"
    ji.save_inception_weights(ji.random_inception_params(seed=7), str(path))
    imgs = [np.random.default_rng(s).integers(0, 256, (3, 3, 32, 32), dtype=np.uint8) for s in range(4)]
    port = mt.FrechetInceptionDistance(feature=64, weights_path=str(path), device="cpu")
    jax_m = mj.FrechetInceptionDistance(feature=64, weights_path=str(path))
    assert port.feature_dim == 64 and port.inception.device == torch.device("cpu")
    for i, b in enumerate(imgs):
        port.update(torch.from_numpy(b), real=i < 2)
        jax_m.update(jnp.asarray(b), real=i < 2)
    np.testing.assert_allclose(port.real_sum.numpy(), np.asarray(jax_m.real_sum), rtol=1e-4, atol=1e-4)
    assert np.isfinite(float(port.compute()))
    # the network keeps one stream wrapper per device, so FIDs of one weights file share its programs
    other = mt.FrechetInceptionDistance(feature=64, weights_path=str(path), device="cpu")
    assert other.inception is port.inception and other._stream_encoder() is port._stream_encoder()
    other.update_stream([torch.from_numpy(imgs[0])], real=True)
    assert "_stream_encoders" not in pickle.loads(pickle.dumps(port.inception)).__dict__


# --------------------------------------------------------------------- KID
@pytest.mark.parametrize("kwargs", [{"subsets": 4, "subset_size": 10}, {"subsets": 3, "subset_size": 20, "degree": 2, "gamma": 0.5, "coef": 2.0}])
def test_kid_same_subsets_mean_and_std_follow_jax(kwargs):
    port = _feed(mt.KernelInceptionDistance(feature=port_extractor, device="cpu", **kwargs), torch.from_numpy)
    jax_m = _feed(mj.KernelInceptionDistance(feature=jax_extractor, **kwargs), _jax)
    (pm, ps), (jm, js) = port.compute(), jax_m.compute()
    np.testing.assert_allclose([float(pm), float(ps)], [float(jm), float(js)], rtol=1e-5, atol=1e-7)
    # the std has ddof 0: a numpy loop over the same subsets
    feats_r = torch.cat([port_extractor(torch.from_numpy(b)) for b in REAL]).double().numpy()
    feats_f = torch.cat([port_extractor(torch.from_numpy(b)) for b in FAKE]).double().numpy()
    ridx, fidx = port.subset_indices(len(feats_r), len(feats_f))
    scores = []
    for r, f in zip(ridx, fidx):
        x, y = feats_r[r], feats_f[f]
        g = kwargs.get("gamma") or 1.0 / D

        def k(a, b):
            return (a @ b.T * g + kwargs.get("coef", 1.0)) ** kwargs.get("degree", 3)

        m = len(r)
        kxx, kyy, kxy = k(x, x), k(y, y), k(x, y)
        scores.append((kxx.sum() - np.trace(kxx) + kyy.sum() - np.trace(kyy)) / (m * (m - 1)) - 2 * kxy.sum() / m**2)
    np.testing.assert_allclose([float(pm), float(ps)], [np.mean(scores), np.std(scores, ddof=0)], rtol=1e-5, atol=1e-7)


def test_kid_validation_errors():
    for kwargs, match in (
        ({"subsets": 0}, "subsets"),
        ({"subset_size": -1}, "subset_size"),
        ({"degree": 0}, "degree"),
        ({"gamma": 1}, "gamma"),
        ({"coef": 1}, "coef"),
    ):
        with pytest.raises(ValueError, match=match):
            mt.KernelInceptionDistance(feature=port_extractor, device="cpu", **kwargs)
    kid = _feed(mt.KernelInceptionDistance(feature=port_extractor, subset_size=100, device="cpu"), torch.from_numpy)
    with pytest.raises(ValueError, match="smaller than the number of samples"):
        kid.compute()


# ---------------------------------------------------------------------- IS
def _logits(imgs):
    return port_extractor(imgs) * 3.0


def _jax_logits(imgs):
    return jax_extractor(imgs) * 3.0


@pytest.mark.parametrize("n,splits", [(61, 10), (5, 10), (40, 3)], ids=["61-in-10", "fewer-than-splits", "40-in-3"])
def test_inception_score_follows_jax(n, splits):
    imgs = np.concatenate(REAL)[:n]
    port = mt.InceptionScore(feature=_logits, splits=splits, device="cpu")
    jax_m = mj.InceptionScore(feature=_jax_logits, splits=splits)
    port.update(torch.from_numpy(imgs))
    jax_m.update(jnp.asarray(imgs))
    (pm, ps), (jm, js) = port.compute(), jax_m.compute()
    # atol: the JAX package computes in float32 (where a split of one sample
    # scores 1 within 1e-7, not exactly), the port in float64
    np.testing.assert_allclose([float(pm), float(ps)], [float(jm), float(js)], rtol=1e-5, atol=1e-6)
    # ddof 1 over torch.chunk's ceil-sized splits of the seeded shuffle
    p = torch.from_numpy(np.asarray(_logits(torch.from_numpy(imgs)), np.float64))
    p = p[torch.from_numpy(np.random.default_rng(42).permutation(n))]
    scores = []
    for chunk in p.softmax(1).chunk(splits):
        scores.append(np.exp(float((chunk * (chunk.log() - chunk.mean(0, keepdim=True).log())).sum(1).mean())))
    # a split of one sample scores exp(0) = 1 exactly in float64, so the std of those is 0
    np.testing.assert_allclose([float(pm), float(ps)], [np.mean(scores), np.std(scores, ddof=1)], rtol=1e-5, atol=1e-6)


def test_inception_score_validation():
    with pytest.raises(ValueError, match="must be one of"):
        mt.InceptionScore(feature="probabilities", device="cpu")
    with pytest.raises(ValueError, match="No samples"):  # as the JAX package's dim_zero_cat
        mt.InceptionScore(feature=_logits, device="cpu").compute()
    empty = mt.InceptionScore(feature=lambda imgs: torch.zeros(imgs.shape[0], D), device="cpu")
    empty.update(torch.zeros(0, 3, 8, 8))
    with pytest.raises(MetricsUserError, match="at least one sample"):
        empty.compute()


# ------------------------------------------------------------------- LPIPS
def test_lpips_metric_streams_like_jax_with_both_normalizations(tmp_path, monkeypatch):
    params = jl.random_lpips_params("alex", seed=3)
    path = tmp_path / "alex.npz"
    jl.save_lpips_weights(params, str(path))
    rng = np.random.default_rng(8)
    batches = [(rng.random((2, 3, 64, 64)).astype(np.float32), rng.random((2, 3, 64, 64)).astype(np.float32)) for _ in range(2)]
    for normalize in (True, False):
        port = mt.LearnedPerceptualImagePatchSimilarity(net="alex", normalize=normalize, weights_path=str(path), device="cpu")
        jax_m = mj.LearnedPerceptualImagePatchSimilarity(net="alex", normalize=normalize, weights_path=str(path))
        per_pair = []
        for a, b in batches:
            port.update(torch.from_numpy(a), torch.from_numpy(b))
            jax_m.update(jnp.asarray(a), jnp.asarray(b))
            x, y = (2 * a - 1, 2 * b - 1) if normalize else (a, b)
            per_pair.append(tl.LPIPSNetwork(lpips_params_from_jax(params, "alex", device="cpu"), "alex")(torch.from_numpy(x), torch.from_numpy(y)))
        _rel(port.compute(), jax_m.compute(), 1e-5)
        _rel(port.compute(), torch.cat(per_pair).mean(), 1e-6)
        assert float(port.total) == 4.0
    monkeypatch.setenv(tl.ENV_WEIGHTS_VAR, str(path))
    assert isinstance(mt.LearnedPerceptualImagePatchSimilarity(device="cpu").net, tl.LPIPSNetwork)
    with pytest.raises(ModuleNotFoundError, match="'squeeze'"):
        mt.LearnedPerceptualImagePatchSimilarity(net="squeeze", device="cpu")
    with pytest.raises(ValueError, match="must be one of"):
        mt.LearnedPerceptualImagePatchSimilarity(net="resnet", device="cpu")
    with pytest.raises(ValueError, match="normalize"):
        mt.LearnedPerceptualImagePatchSimilarity(net=lambda a, b: a, normalize=1, device="cpu")


# ---------------------------------------------------------------- encoders
def _apply(params, x):
    return x @ params["w"]


def _w():
    return np.random.RandomState(0).normal(size=(12, 8)).astype(np.float32)


def _sum_consumer(carry, feats, valid):
    f = feats * valid[:, None]
    return {"s": carry["s"] + f.sum(0), "n": carry["n"] + valid.sum()}


def _jax_sum_consumer(carry, feats, valid):
    f = feats * valid[:, None]
    return {"s": carry["s"] + jnp.sum(f, axis=0), "n": carry["n"] + valid.sum()}


def test_sharded_encoder_from_callable_and_stats():
    enc = ShardedEncoder(_apply, {"w": torch.from_numpy(_w())}, name="mlp")
    assert enc.device == torch.device("cpu") and enc.params_nbytes() == 12 * 8 * 4
    x = torch.from_numpy(np.random.RandomState(1).rand(6, 12).astype(np.float32))
    np.testing.assert_array_equal(enc(x).numpy(), (x @ torch.from_numpy(_w())).numpy())
    enc.encode(x)
    other = ShardedEncoder(_apply, {"w": torch.zeros(12, 8)}, name="mlp2")  # same identity, other weights
    np.testing.assert_array_equal(other(x).numpy(), np.zeros((6, 8), np.float32))
    assert enc.compile_stats() == {"compiles": 1, "cache_hits": 1, "retraces": 0, "donated_bytes": 0, "bucketed_calls": 0}
    assert other.compile_stats()["cache_hits"] == 1
    wrapped = ShardedEncoder.from_callable(lambda t: t * 2, name="double", device="cpu")
    np.testing.assert_array_equal(wrapped(x).numpy(), (x * 2).numpy())
    stats = encoder_stats()
    assert stats["encode_calls"] == 4 and stats["fused_calls"] == 0 and stats["placements"] == 0
    assert copy.deepcopy(enc) is enc
    back = pickle.loads(pickle.dumps(enc))
    np.testing.assert_array_equal(back(x).numpy(), enc(x).numpy())
    reset_encoder_stats()
    assert encoder_stats()["encode_calls"] == 0
    # the mesh arguments hold their annotations unplaced (placed: test_torch_encoder_mesh.py)
    annotated = ShardedEncoder(_apply, {"w": torch.zeros(12, 8)}, param_specs={"w": "mp"}, in_specs="dp", out_spec="mp")
    assert annotated.mesh is None and annotated.batch_multiple() == 1 and annotated.row_window(6) is None
    with pytest.raises(MetricsUserError, match="named dims"):
        ShardedEncoder(_apply, {"w": torch.zeros(12, 8)}, param_specs={"w": "mp"}, mesh=object())
    with pytest.raises(MetricsUserError, match="named dims"):
        annotated.place(object())


class _Screen:
    """Duck-typed owner metric: the policy attributes and host health stats."""

    def __init__(self, policy):
        self.on_bad_input = policy
        self.health_screen = "nonfinite"
        self._health_stats = {"batches_screened": 0}


@pytest.mark.parametrize("policy", ["propagate", "mask", "skip"])
def test_encode_stream_ragged_tail_and_screening_follow_jax(policy):
    rng = np.random.RandomState(6)
    batches = [rng.rand(8, 12).astype(np.float32) for _ in range(3)] + [rng.rand(5, 12).astype(np.float32)]
    batches[1][2, 3] = np.nan
    batches[1][5, 0] = np.inf
    port_enc = ShardedEncoder(_apply, {"w": torch.from_numpy(_w())}, name="mlp")
    jax_enc = mj.ShardedEncoder(_apply, {"w": jnp.asarray(_w())}, name="mlp")
    carry_p, res_p = encode_stream(
        port_enc, batches, _sum_consumer, {"s": torch.zeros(8), "n": torch.tensor(0.0)}, screen=_Screen(policy)
    )
    carry_j, res_j = j_encode_stream(
        jax_enc, batches, _jax_sum_consumer, {"s": jnp.zeros(8, jnp.float32), "n": jnp.asarray(0.0, jnp.float32)}, screen=_Screen(policy)
    )
    assert (res_p.chunks, res_p.rows, res_p.rows_screened, res_p.batches_quarantined) == (
        res_j.chunks, res_j.rows, res_j.rows_screened, res_j.batches_quarantined
    )
    assert float(carry_p["n"]) == float(carry_j["n"])
    if policy == "propagate":
        assert np.isnan(carry_p["s"].numpy()).all() and np.isnan(np.asarray(carry_j["s"])).all()
    else:
        np.testing.assert_allclose(carry_p["s"].numpy(), np.asarray(carry_j["s"]), rtol=1e-6)
    assert encoder_stats()["bucketed_dispatches"] == 1  # the ragged 5-row tail, padded to 8


def test_encode_stream_raise_policy_raises_before_the_encoder():
    calls = []

    def probe(params, x):
        calls.append(1)
        return x

    enc = ShardedEncoder(probe, (), name="probe", device="cpu")
    with pytest.raises(NumericalHealthError, match="BEFORE the encoder"):
        encode_stream(enc, [np.full((4, 12), np.nan, np.float32)], _sum_consumer, {"s": torch.zeros(12), "n": torch.tensor(0.0)}, screen=_Screen("raise"))
    assert calls == []
    with pytest.raises(ValueError, match="leading batch axis"):
        encode_stream(enc, [(torch.zeros(4, 12), torch.zeros(3, 12))], _sum_consumer, {})


# -------------------------------------------------------------- deprecated
@pytest.mark.parametrize(
    "alias,kwargs",
    [
        ("FID", {"feature": "extractor", "feature_dim": D}),
        ("KID", {"feature": "extractor", "subset_size": 10}),
        ("IS", {"feature": "extractor"}),
        ("LPIPS", {"net": "distance"}),
    ],
)
def test_generative_aliases_warn_like_jax_and_construct(alias, kwargs):
    def resolve(pkg_extractor, distance):
        return {k: (pkg_extractor if v == "extractor" else distance if v == "distance" else v) for k, v in kwargs.items()}

    with pytest.warns(DeprecationWarning) as port_caught:
        port = getattr(dt, alias)(device="cpu", **resolve(port_extractor, lambda a, b: ((a - b) ** 2).mean((1, 2, 3))))
    with pytest.warns(DeprecationWarning) as jax_caught:
        getattr(dj, alias)(**resolve(jax_extractor, lambda a, b: jnp.mean((a - b) ** 2, axis=(1, 2, 3))))
    assert [str(w.message) for w in port_caught] == [str(w.message) for w in jax_caught]
    assert isinstance(port, getattr(mt, alias).__mro__[1]) and getattr(mt, alias) is getattr(dt, alias)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if alias == "LPIPS":
            port.update(torch.from_numpy(REAL[0]), torch.from_numpy(REAL[1]))
        elif alias == "IS":
            port.update(torch.from_numpy(REAL[0]))
        else:
            _feed(port, torch.from_numpy)
        value = port.compute()
        assert all(np.isfinite(float(v)) for v in (value if isinstance(value, tuple) else (value,)))

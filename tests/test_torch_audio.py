"""The port's audio metrics against ``metrics_tpu`` on the same seeded numpy
signals: the SNR family, SDR (its ``filter_length`` clamp and
``load_diag``), PIT on both assignment paths and ``pit_permutate``, STOI and
ESTOI at 8, 10 and 16 kHz (silent gaps, the short-signal sentinel, integer
PCM) and the resampler against ``scipy.signal.resample_poly``; every
module's ``forward``, streamed ``compute()``, ``state_dict`` and checkpoint
tree, crossed both ways; the PESQ gate's message.

Tolerances (both packages on the same inputs):

=========  ===========  ============================  ======
input      SNR family   SDR                           STOI
=========  ===========  ============================  ======
float64    1e-7 dB      1e-6 dB                       1e-7
float32    1e-4 dB      1e-3 dB at SDR up to 25 dB    2e-4
=========  ===========  ============================  ======

The resampler is held to scipy within 1e-6 (float64) and 1e-4 (float32),
the JAX suite's own tolerances. Signals are short and few shapes are used:
the JAX package compiles STOI once per shape.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import resample_poly

import metrics_tpu as mj
import metrics_tpu.functional.audio as fj
import metrics_tpu.functional.audio.pit as pit_jax
import metrics_tpu.utils.checkpoint as cj
import metrics_tpu_torch as mt
import metrics_tpu_torch.functional.audio as ft
import metrics_tpu_torch.functional.audio.pit as pit_port
import metrics_tpu_torch.utils.checkpoint as ct
from metrics_tpu_torch.functional.audio.stoi import _resample
from tests.helpers.stoi_oracle import resample_filter, stoi_oracle

DTYPES = [np.float32, np.float64]
SNR_ATOL = {np.float32: 1e-4, np.float64: 1e-7}
SDR_ATOL = {np.float32: 1e-3, np.float64: 1e-6}
STOI_ATOL = {np.float32: 2e-4, np.float64: 1e-7}
STOI_SECONDS = 6  # tenths of a second: 0.6 s keeps 30 frames after a 20% silent gap
SDR_F32_MAX_DB = 25.0  # the float32 tolerance holds up to here (``1 - coh`` cancels above)


def _speechlike(rng, n: int, fs: int, silent_gap: bool = False) -> np.ndarray:
    """Band-structured modulated noise; a silent gap drops frames 40 dB down."""
    t = np.arange(n) / fs
    x = (0.5 + 0.5 * np.sin(2 * np.pi * 3.1 * t)) * (rng.standard_normal(n) + 0.3 * np.sin(2 * np.pi * 440 * t))
    if silent_gap:
        x[int(0.35 * n) : int(0.55 * n)] *= 1e-4
    return x


def _pair(seed: int, shape, dtype, noise: float = 0.3):
    rng = np.random.default_rng(seed)
    target = rng.standard_normal(shape)
    preds = target + noise * rng.standard_normal(shape)
    return preds.astype(dtype), target.astype(dtype)


def _close(got, want, atol: float, dtype=None) -> None:
    g, w = got.detach().cpu().numpy(), np.asarray(want)
    assert g.shape == w.shape
    if dtype is not None:
        assert g.dtype == w.dtype == dtype
    np.testing.assert_allclose(g, w, rtol=0, atol=atol)


SNR_FAMILY = [
    ("signal_noise_ratio", {}),
    ("signal_noise_ratio", {"zero_mean": True}),
    ("scale_invariant_signal_noise_ratio", {}),
    ("scale_invariant_signal_distortion_ratio", {}),
    ("scale_invariant_signal_distortion_ratio", {"zero_mean": True}),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name,kwargs", SNR_FAMILY, ids=[f"{n}-{'zm' if k else 'plain'}" for n, k in SNR_FAMILY])
def test_snr_family_follows_jax(name, kwargs, dtype):
    preds, target = _pair(1, (2, 3, 300), dtype)
    got = getattr(ft, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    want = getattr(fj, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    _close(got, want, SNR_ATOL[dtype], np.dtype(dtype))


@pytest.mark.parametrize("in_dtype,out_dtype", [(torch.float16, torch.float32), (torch.bfloat16, torch.float32), (torch.int32, torch.float32)])
def test_snr_promotes_like_jax(in_dtype, out_dtype):
    preds, target = _pair(2, (3, 64), np.float32)
    got = ft.signal_noise_ratio(torch.from_numpy(preds).to(in_dtype), torch.from_numpy(target).to(in_dtype))
    assert got.dtype == out_dtype


SDR_CASES = [
    ("default-clamped", {}),  # filter_length 512 on 300 samples: clamped to 300
    ("filter64", {"filter_length": 64}),
    ("zero-mean", {"filter_length": 32, "zero_mean": True}),
    ("load-diag", {"filter_length": 48, "load_diag": 1e-2}),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("label,kwargs", SDR_CASES, ids=[c[0] for c in SDR_CASES])
def test_sdr_follows_jax(label, kwargs, dtype):
    preds, target = _pair(3, (2, 2, 300), dtype, noise=0.2)
    preds = preds + np.float32(0.5)  # an offset for zero_mean to remove
    got = ft.signal_distortion_ratio(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    want = fj.signal_distortion_ratio(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    assert np.asarray(want).max() <= SDR_F32_MAX_DB
    _close(got, want, SDR_ATOL[dtype], np.dtype(dtype))


def test_sdr_clamps_the_filter_to_the_signal():
    preds, target = _pair(4, (3, 40), np.float64)
    p, t = torch.from_numpy(preds), torch.from_numpy(target)
    assert torch.equal(ft.signal_distortion_ratio(p, t, filter_length=512), ft.signal_distortion_ratio(p, t, filter_length=40))


def test_sdr_float32_against_a_float64_solve():
    """float32 SDR against the float64 JAX path on the same signals, where the
    SDR is at most 25 dB."""
    preds, target = _pair(5, (4, 2000), np.float64, noise=0.1)
    got = ft.signal_distortion_ratio(torch.from_numpy(preds.astype(np.float32)), torch.from_numpy(target.astype(np.float32)))
    want = np.asarray(fj.signal_distortion_ratio(jnp.asarray(preds), jnp.asarray(target)))
    assert want.max() <= SDR_F32_MAX_DB
    np.testing.assert_allclose(got.numpy(), want, atol=SDR_ATOL[np.float32])


def _speaker_mix(seed: int, batch: int, spk: int, n: int, dtype):
    rng = np.random.default_rng(seed)
    target = rng.standard_normal((batch, spk, n))
    order = np.stack([rng.permutation(spk) for _ in range(batch)])
    preds = np.take_along_axis(target, order[:, :, None], axis=1) + 0.3 * rng.standard_normal((batch, spk, n))
    return preds.astype(dtype), target.astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("eval_func", ["max", "min"])
@pytest.mark.parametrize("path", ["exhaustive", "lsa"])
def test_pit_follows_jax(path, eval_func, dtype):
    preds, target = _speaker_mix(6, 4, 3, 120, dtype)
    old = pit_jax._EXHAUSTIVE_MAX_SPK, pit_port._EXHAUSTIVE_MAX_SPK
    try:
        if path == "lsa":
            pit_jax._EXHAUSTIVE_MAX_SPK = pit_port._EXHAUSTIVE_MAX_SPK = 0
        got_v, got_p = ft.permutation_invariant_training(
            torch.from_numpy(preds), torch.from_numpy(target), ft.scale_invariant_signal_distortion_ratio, eval_func
        )
        want_v, want_p = fj.permutation_invariant_training(
            jnp.asarray(preds), jnp.asarray(target), fj.scale_invariant_signal_distortion_ratio, eval_func
        )
    finally:
        pit_jax._EXHAUSTIVE_MAX_SPK, pit_port._EXHAUSTIVE_MAX_SPK = old
    _close(got_v, want_v, SNR_ATOL[dtype], np.dtype(dtype))
    assert got_p.dtype == torch.int32
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    aligned = ft.pit_permutate(torch.from_numpy(preds), got_p)
    np.testing.assert_array_equal(aligned.numpy(), np.asarray(fj.pit_permutate(jnp.asarray(preds), want_p)))


def test_pit_ties_go_to_the_first_permutation():
    """Identical speakers: every permutation scores the same, both packages keep the identity."""
    target = np.tile(np.random.default_rng(7).standard_normal((1, 1, 50)), (2, 3, 1))
    got = ft.permutation_invariant_training(torch.from_numpy(target), torch.from_numpy(target), ft.signal_noise_ratio)
    want = fj.permutation_invariant_training(jnp.asarray(target), jnp.asarray(target), fj.signal_noise_ratio)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[1].numpy(), np.tile(np.arange(3), (2, 1)))


def test_pit_rejects_what_jax_rejects():
    x = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="eval_func"):
        ft.permutation_invariant_training(x, x, ft.signal_noise_ratio, "mean")
    with pytest.raises(ValueError, match="batch, spk"):
        ft.permutation_invariant_training(torch.zeros(4), torch.zeros(4), ft.signal_noise_ratio)


@pytest.mark.parametrize("spk,falls_back", [(3, False), (7, True)], ids=["exhaustive-3", "lsa-7"])
def test_pit_module_falls_back_to_eager_past_six_speakers(spk, falls_back):
    """Past six speakers the assignment reads the metric matrix on the host:
    the engine's program refuses it and the metric runs its eager update,
    with the same values."""
    port = mt.PermutationInvariantTraining(ft.scale_invariant_signal_noise_ratio, device="cpu")
    ref = mj.PermutationInvariantTraining(fj.scale_invariant_signal_noise_ratio)
    for seed in range(3):
        preds, target = _speaker_mix(10 + seed, 2, spk, 64, np.float32)
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        ref.update(jnp.asarray(preds), jnp.asarray(target))
    assert port.compile_stats()["jit_failed"] is falls_back
    _close(port.compute(), ref.compute(), SNR_ATOL[np.float32])


@pytest.mark.parametrize("fs", [8000, 16000])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_resampler_matches_scipy(fs, dtype):
    x = np.random.default_rng(8).standard_normal((3, fs // 4))
    h = resample_filter(10000, fs)
    want = np.stack([resample_poly(row, 10000, fs, window=h / h.sum()) for row in x])
    got = _resample(torch.from_numpy(x.astype(dtype)), fs)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6 if dtype == np.float64 else 1e-4, rtol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("extended", [False, True], ids=["stoi", "estoi"])
@pytest.mark.parametrize("fs", [8000, 10000, 16000])
def test_stoi_follows_jax_and_the_oracle(fs, extended, dtype):
    """0.6 s of two speech-like signals, the second with a silent gap."""
    rng = np.random.default_rng(9)
    n = STOI_SECONDS * fs // 10
    target = np.stack([_speechlike(rng, n, fs), _speechlike(rng, n, fs, silent_gap=True)])
    preds = target + 0.5 * rng.standard_normal(target.shape)
    preds, target = preds.astype(dtype), target.astype(dtype)
    got = ft.short_time_objective_intelligibility(torch.from_numpy(preds), torch.from_numpy(target), fs, extended)
    want = fj.short_time_objective_intelligibility(jnp.asarray(preds), jnp.asarray(target), fs, extended)
    _close(got, want, STOI_ATOL[dtype], np.dtype(dtype))
    oracle = [stoi_oracle(t, p, fs, extended) for t, p in zip(target.astype(np.float64), preds.astype(np.float64))]
    np.testing.assert_allclose(got.numpy(), oracle, atol=STOI_ATOL[dtype])


@pytest.mark.parametrize("n", [200, 3000], ids=["no-frame", "under-30-frames"])
def test_stoi_short_signals_give_the_sentinel(n):
    preds, target = _pair(11, (2, n), np.float32)
    got = ft.short_time_objective_intelligibility(torch.from_numpy(preds), torch.from_numpy(target), 10000)
    want = fj.short_time_objective_intelligibility(jnp.asarray(preds), jnp.asarray(target), 10000)
    _close(got, want, 0.0, np.float32)
    assert np.all(got.numpy() == np.float32(1e-5))


def test_stoi_promotes_integer_pcm():
    rng = np.random.default_rng(12)
    n = STOI_SECONDS * 800  # the 8 kHz shape of the test above: the JAX package compiles it once
    target = (8000 * np.stack([_speechlike(rng, n, 8000) for _ in range(2)])).astype(np.int16)
    preds = (target + 2000 * rng.standard_normal(target.shape)).astype(np.int16)
    got = ft.short_time_objective_intelligibility(torch.from_numpy(preds), torch.from_numpy(target), 8000)
    want = fj.short_time_objective_intelligibility(jnp.asarray(preds), jnp.asarray(target), 8000)
    _close(got, want, STOI_ATOL[np.float32], np.float32)


# module, constructor kwargs (port, JAX), per-batch input shape, tolerance
def _pit_kwargs(pkg):
    return {"metric_func": (ft if pkg is mt else fj).scale_invariant_signal_noise_ratio}


MODULES = [
    ("SignalNoiseRatio", {"zero_mean": True}, (4, 300), SNR_ATOL),
    ("ScaleInvariantSignalNoiseRatio", {}, (2, 2, 300), SNR_ATOL),
    ("ScaleInvariantSignalDistortionRatio", {}, (4, 300), SNR_ATOL),
    ("SignalDistortionRatio", {"filter_length": 64}, (3, 300), SDR_ATOL),
    ("PermutationInvariantTraining", "pit", (3, 2, 300), SNR_ATOL),
    # the 16 kHz shape of the STOI test above: the JAX package compiles it once
    ("ShortTimeObjectiveIntelligibility", {"fs": 16000, "extended": True}, (2, STOI_SECONDS * 1600), STOI_ATOL),
]


def _module(pkg, name, kwargs, **extra):
    kwargs = _pit_kwargs(pkg) if kwargs == "pit" else kwargs
    return getattr(pkg, name)(**kwargs, **extra)


def _module_batches(shape, dtype, n: int = 3):
    return [_pair(20 + i, shape, dtype, noise=0.4) for i in range(n)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name,kwargs,shape,tol", MODULES, ids=[m[0] for m in MODULES])
def test_audio_module_forward_and_stream_follow_jax(name, kwargs, shape, tol, dtype):
    port, ref = _module(mt, name, kwargs, device="cpu"), _module(mj, name, kwargs)
    batches = _module_batches(shape, dtype)
    first = batches[0]
    _close(port(*map(torch.from_numpy, first)), ref(*map(jnp.asarray, first)), tol[dtype])
    for b in batches[1:]:
        port.update(*map(torch.from_numpy, b))
        ref.update(*map(jnp.asarray, b))
    got, want = port.compute(), ref.compute()
    _close(got, want, tol[dtype])
    assert port.total.dtype == torch.int64 and int(port.total) == int(ref.total)
    assert sorted(port._defaults) == sorted(ref._defaults)
    assert {n: port._reductions[n] for n in port._defaults} == {n: ref._reductions[n] for n in ref._defaults}
    assert (port.is_differentiable, port.higher_is_better) == (ref.is_differentiable, ref.higher_is_better)


@pytest.mark.parametrize("name,kwargs,shape,tol", MODULES, ids=[m[0] for m in MODULES])
def test_audio_state_dicts_and_trees_cross_both_ways(name, kwargs, shape, tol):
    """JAX takes batch 0, the port takes its state and batch 1, JAX takes the
    port's state back and batch 2: equal to JAX over all three. Then the
    checkpoint trees, each way."""
    batches = _module_batches(shape, np.float32)
    whole = _module(mj, name, kwargs)
    for b in batches:
        whole.update(*map(jnp.asarray, b))
    first = _module(mj, name, kwargs)
    first.update(*map(jnp.asarray, batches[0]))
    first.persistent(True)
    port = _module(mt, name, kwargs, device="cpu")
    port.persistent(True)
    loaded = port.load_state_dict(mt.state_from_jax(first.state_dict()))
    assert not loaded.missing_keys and not loaded.unexpected_keys
    port.update(*map(torch.from_numpy, batches[1]))
    back = _module(mj, name, kwargs)
    back.persistent(True)
    back.load_state_dict(mt.state_to_jax(port.state_dict()))
    back.update(*map(jnp.asarray, batches[2]))
    np.testing.assert_allclose(np.asarray(back.compute()), np.asarray(whole.compute()), atol=tol[np.float32])

    fresh = _module(mt, name, kwargs, device="cpu")
    ct.restore_metric_state_pytree(fresh, cj.metric_state_pytree(whole))
    _close(fresh.compute(), whole.compute(), tol[np.float32])
    fresh_jax = _module(mj, name, kwargs)
    cj.restore_metric_state_pytree(fresh_jax, ct.metric_state_pytree(fresh))
    np.testing.assert_allclose(np.asarray(fresh_jax.compute()), np.asarray(whole.compute()), atol=tol[np.float32])


@pytest.mark.parametrize("name,kwargs,shape,tol", MODULES, ids=[m[0] for m in MODULES])
def test_audio_updates_stay_in_the_engine_program(name, kwargs, shape, tol):
    """Every update runs as one engine program on the CPU under the host-sync
    guard (STOI when asked with ``jit_update=True``): no host read, so each
    is captured on the card, except SDR, whose batched LU (MAGMA at
    ``chip_smoke.py``'s shape) the toolkit refuses to capture there; the
    values equal the eager update's."""
    captured = _module(mt, name, kwargs, device="cpu", jit_update=True)
    eager = _module(mt, name, kwargs, device="cpu", jit_update=False)
    for b in _module_batches(shape, np.float32):
        captured.update(*map(torch.from_numpy, b))
        eager.update(*map(torch.from_numpy, b))
    stats = captured.compile_stats()
    assert stats["jit_failed"] is False and stats["compiles"] + stats["cache_hits"] == 3
    _close(captured.compute(), eager.compute(), 0.0)


def test_stoi_module_defaults_to_the_eager_update():
    assert mt.ShortTimeObjectiveIntelligibility(8000, device="cpu").compile_stats()["jit_enabled"] is False
    assert mj.ShortTimeObjectiveIntelligibility(8000).compile_stats()["jit_enabled"] is False


def test_pit_splits_metric_kwargs_from_metric_func_kwargs():
    pit = mt.PermutationInvariantTraining(ft.signal_noise_ratio, device="cpu", compute_on_step=False, zero_mean=True)
    assert pit.kwargs == {"zero_mean": True} and pit.compute_on_step is False and pit.device.type == "cpu"
    ref = mj.PermutationInvariantTraining(fj.signal_noise_ratio, compute_on_step=False, zero_mean=True)
    preds, target = _speaker_mix(30, 2, 2, 100, np.float64)
    pit.update(torch.from_numpy(preds), torch.from_numpy(target))
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    _close(pit.compute(), ref.compute(), SNR_ATOL[np.float64])


def _raised(fn) -> str:
    with pytest.raises(ModuleNotFoundError) as err:
        fn()
    return str(err.value)


def test_pesq_gate_raises_the_jax_message():
    x = np.zeros(16000, np.float32)
    assert _raised(lambda: ft.perceptual_evaluation_speech_quality(torch.from_numpy(x), torch.from_numpy(x), 16000, "wb")) == _raised(
        lambda: fj.perceptual_evaluation_speech_quality(jnp.asarray(x), jnp.asarray(x), 16000, "wb")
    )
    assert _raised(lambda: mt.PerceptualEvaluationSpeechQuality(16000, "wb", device="cpu")) == _raised(
        lambda: mj.PerceptualEvaluationSpeechQuality(16000, "wb")
    )


def test_audio_metrics_default_to_cuda():
    makers = [
        lambda: mt.SignalNoiseRatio(),
        lambda: mt.ScaleInvariantSignalNoiseRatio(),
        lambda: mt.SignalDistortionRatio(),
        lambda: mt.ScaleInvariantSignalDistortionRatio(),
        lambda: mt.PermutationInvariantTraining(ft.signal_noise_ratio),
        lambda: mt.ShortTimeObjectiveIntelligibility(8000),
        lambda: mt.MeanAveragePrecision(),
    ]
    if torch.cuda.is_available():
        assert all(make().device.type == "cuda" for make in makers)
        return
    for make in makers:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                make()

"""The port's deprecated short names: each class alias warns on construction
with the JAX package's ``DeprecationWarning`` text and then is its target;
each functional alias warns on call and returns its target's value. Values
equal the target's exactly (the same code runs).

The package roots: every name of ``metrics_tpu.__all__`` and
``metrics_tpu.functional.__all__`` whose definition the port has resolves on
the port's root too (the list is derived from the JAX roots, not written
out)."""
import importlib
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mj
import metrics_tpu.deprecated as dj
import metrics_tpu.functional as fj
import metrics_tpu.functional.deprecated as fdj
import metrics_tpu_torch as mt
import metrics_tpu_torch.deprecated as dt
import metrics_tpu_torch.functional as ft
import metrics_tpu_torch.functional.deprecated as fdt

RNG = np.random.default_rng(61)
LOGITS = RNG.standard_normal((30, 4)).astype(np.float32)
LABELS = RNG.integers(0, 4, 30)
X = RNG.standard_normal(30).astype(np.float32)
Y = (X + RNG.standard_normal(30)).astype(np.float32)
IMG = RNG.random((2, 3, 16, 16)).astype(np.float32)
IMG_NOISY = np.clip(IMG + 0.1 * RNG.standard_normal(IMG.shape), 0, 1).astype(np.float32)
WAVE = RNG.standard_normal((2, 3000)).astype(np.float32)
WAVE_NOISY = (WAVE + 0.3 * RNG.standard_normal(WAVE.shape)).astype(np.float32)
SPEAKERS = RNG.standard_normal((2, 2, 200)).astype(np.float32)
SPEAKERS_MIXED = (SPEAKERS[:, ::-1] + 0.2 * RNG.standard_normal(SPEAKERS.shape)).astype(np.float32)

# alias, target, constructor kwargs, inputs
CLASSES = [
    ("F1", "F1Score", {"num_classes": 4, "average": "macro"}, (LOGITS, LABELS)),
    ("FBeta", "FBetaScore", {"num_classes": 4, "beta": 0.5}, (LOGITS, LABELS)),
    ("Hinge", "HingeLoss", {}, (LOGITS, LABELS)),
    ("IoU", "JaccardIndex", {"num_classes": 4}, (LOGITS, LABELS)),
    ("MatthewsCorrcoef", "MatthewsCorrCoef", {"num_classes": 4}, (LOGITS, LABELS)),
    ("PearsonCorrcoef", "PearsonCorrCoef", {}, (X, Y)),
    ("SpearmanCorrcoef", "SpearmanCorrCoef", {}, (X, Y)),
    ("PSNR", "PeakSignalNoiseRatio", {"data_range": 1.0}, (IMG_NOISY, IMG)),
    ("SSIM", "StructuralSimilarityIndexMeasure", {"data_range": 1.0}, (IMG_NOISY, IMG)),
    ("SNR", "SignalNoiseRatio", {}, (WAVE_NOISY, WAVE)),
    ("SDR", "SignalDistortionRatio", {"filter_length": 32}, (WAVE_NOISY, WAVE)),
    ("SI_SDR", "ScaleInvariantSignalDistortionRatio", {}, (WAVE_NOISY, WAVE)),
    ("SI_SNR", "ScaleInvariantSignalNoiseRatio", {}, (WAVE_NOISY, WAVE)),
    ("STOI", "ShortTimeObjectiveIntelligibility", {"fs": 10000}, (WAVE_NOISY, WAVE)),
    ("PIT", "PermutationInvariantTraining", {"metric_func": "si_snr"}, (SPEAKERS_MIXED, SPEAKERS)),
]


def _resolve(kwargs, functional):
    """``metric_func`` named by the kwargs, taken from the package's functionals."""
    if kwargs.get("metric_func") == "si_snr":
        return {**kwargs, "metric_func": functional.scale_invariant_signal_noise_ratio}
    return kwargs


def _warning_text(fn):
    with pytest.warns(DeprecationWarning) as caught:
        value = fn()
    return value, [str(w.message) for w in caught if w.category is DeprecationWarning]


@pytest.mark.parametrize("alias,target,kwargs,inputs", CLASSES, ids=[c[0] for c in CLASSES])
def test_class_alias_warns_like_jax_and_equals_its_target(alias, target, kwargs, inputs):
    kwargs, jax_kwargs = _resolve(kwargs, ft), _resolve(kwargs, fj)
    port_m, port_msgs = _warning_text(lambda: getattr(dt, alias)(device="cpu", **kwargs))
    _, jax_msgs = _warning_text(lambda: getattr(dj, alias)(**jax_kwargs))
    assert port_msgs == jax_msgs
    assert isinstance(port_m, getattr(mt, target))
    ref = getattr(mt, target)(device="cpu", **kwargs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for m in (port_m, ref):
            m.update(*map(torch.from_numpy, inputs))
        assert torch.equal(port_m.compute(), ref.compute())


# alias, target, inputs, kwargs
FUNCTIONS = [
    ("f1", "f1_score", (LOGITS, LABELS), {"num_classes": 4, "average": "macro"}),
    ("fbeta", "fbeta_score", (LOGITS, LABELS), {"num_classes": 4, "beta": 2.0}),
    ("hinge", "hinge_loss", (LOGITS, LABELS), {"multiclass_mode": "one-vs-all"}),
    ("pairwise_manhatten_distance", "pairwise_manhattan_distance", (LOGITS, LOGITS[:7]), {}),
    ("psnr", "peak_signal_noise_ratio", (IMG_NOISY, IMG), {"data_range": 1.0}),
    ("ssim", "structural_similarity_index_measure", (IMG_NOISY, IMG), {}),
    ("snr", "signal_noise_ratio", (WAVE_NOISY, WAVE), {"zero_mean": True}),
    ("sdr", "signal_distortion_ratio", (WAVE_NOISY, WAVE), {"filter_length": 32}),
    ("si_sdr", "scale_invariant_signal_distortion_ratio", (WAVE_NOISY, WAVE), {}),
    ("si_snr", "scale_invariant_signal_noise_ratio", (WAVE_NOISY, WAVE), {}),
]


@pytest.mark.parametrize("alias,target,inputs,kwargs", FUNCTIONS, ids=[f[0] for f in FUNCTIONS])
def test_functional_alias_warns_like_jax_and_equals_its_target(alias, target, inputs, kwargs):
    got, port_msgs = _warning_text(lambda: getattr(fdt, alias)(*map(torch.from_numpy, inputs), **kwargs))
    _, jax_msgs = _warning_text(lambda: getattr(fdj, alias)(*map(jnp.asarray, inputs), **kwargs))
    assert port_msgs == jax_msgs
    assert getattr(fdt, alias).__name__ == alias
    assert torch.equal(got, getattr(ft, target)(*map(torch.from_numpy, inputs), **kwargs))


def test_map_pesq_and_pit_aliases_warn_like_jax():
    """``MAP`` is its target, ``PESQ`` warns and then raises the gate's
    error, ``pit`` returns its target's value and permutation."""
    port_m, port_msgs = _warning_text(lambda: dt.MAP(device="cpu", class_metrics=True))
    _, jax_msgs = _warning_text(lambda: dj.MAP(class_metrics=True))
    assert port_msgs == jax_msgs and isinstance(port_m, mt.MeanAveragePrecision) and port_m.class_metrics
    for pkg, kw in ((dt, {"device": "cpu"}), (dj, {})):
        with pytest.warns(DeprecationWarning, match="`PESQ` was renamed"), pytest.raises(ModuleNotFoundError, match="pesq"):
            pkg.PESQ(16000, "wb", **kw)
    got, port_msgs = _warning_text(lambda: fdt.pit(*map(torch.from_numpy, (SPEAKERS_MIXED, SPEAKERS)), ft.signal_noise_ratio))
    _, jax_msgs = _warning_text(lambda: fdj.pit(*map(jnp.asarray, (SPEAKERS_MIXED, SPEAKERS)), fj.signal_noise_ratio))
    assert port_msgs == jax_msgs and fdt.pit.__name__ == "pit"
    want = ft.permutation_invariant_training(*map(torch.from_numpy, (SPEAKERS_MIXED, SPEAKERS)), ft.signal_noise_ratio)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _defining_module(obj) -> str:
    """Where a root name is defined: a deprecated function alias's module is
    the one that wraps it (``functools.wraps`` copies the target's
    ``__module__``); a class alias's is the module that built it."""
    if isinstance(obj, types.ModuleType):
        return obj.__name__
    if isinstance(obj, types.FunctionType):
        return obj.__globals__["__name__"]
    return obj.__module__


def _ported_names(jax_root):
    """The names of ``jax_root.__all__`` whose defining module has a port
    counterpart that defines the name too."""
    out = []
    for name in jax_root.__all__:
        module = _defining_module(getattr(jax_root, name))
        assert module.startswith("metrics_tpu.") or module == "metrics_tpu"
        try:
            port_module = importlib.import_module("metrics_tpu_torch" + module[len("metrics_tpu"):])
        except ModuleNotFoundError:
            continue
        if hasattr(port_module, name):
            out.append(name)
    return out


@pytest.mark.parametrize("roots", [(mj, mt), (fj, ft)], ids=["metrics_tpu", "functional"])
def test_the_port_roots_export_every_ported_name_of_the_jax_roots(roots):
    jax_root, port_root = roots
    names = _ported_names(jax_root)
    missing = [n for n in names if not hasattr(port_root, n) or n not in port_root.__all__]
    assert not missing, f"ported but not exported at {port_root.__name__}: {missing}"
    # the names the roots were missing, and this slice's
    pinned = {
        "metrics_tpu": [
            "F1", "FBeta", "Hinge", "IoU", "MatthewsCorrcoef", "PearsonCorrcoef", "SpearmanCorrcoef", "SyncError",
            "NumericalHealthError", "BootStrapper", "ClasswiseWrapper", "MinMaxMetric", "MultioutputWrapper",
            "MetricTracker", "PeakSignalNoiseRatio", "StructuralSimilarityIndexMeasure",
            "MultiScaleStructuralSimilarityIndexMeasure", "PSNR", "SSIM", "FrechetInceptionDistance",
            "KernelInceptionDistance", "InceptionScore", "LearnedPerceptualImagePatchSimilarity", "FID", "KID", "IS",
            "LPIPS", "ShardedEncoder", "BERTScore", "BLEUScore", "CHRFScore", "CharErrorRate", "ExtendedEditDistance",
            "MatchErrorRate", "ROUGEScore", "SQuAD", "SacreBLEUScore", "TranslationEditRate", "WordErrorRate",
            "WordInfoLost", "WordInfoPreserved", "SignalNoiseRatio", "ScaleInvariantSignalNoiseRatio",
            "SignalDistortionRatio", "ScaleInvariantSignalDistortionRatio", "PermutationInvariantTraining",
            "ShortTimeObjectiveIntelligibility", "PerceptualEvaluationSpeechQuality", "MeanAveragePrecision", "PIT",
            "PESQ", "STOI", "SNR", "SDR", "SI_SDR", "SI_SNR", "MAP",
        ],
        "functional": [
            "f1", "fbeta", "hinge", "pairwise_manhatten_distance", "image_gradients", "peak_signal_noise_ratio",
            "structural_similarity_index_measure", "multiscale_structural_similarity_index_measure", "psnr", "ssim",
            "bert_score", "bleu_score", "char_error_rate", "chrf_score", "extended_edit_distance", "match_error_rate",
            "rouge_score", "sacre_bleu_score", "squad", "translation_edit_rate", "word_error_rate",
            "word_information_lost", "word_information_preserved", "signal_noise_ratio",
            "scale_invariant_signal_noise_ratio", "signal_distortion_ratio", "scale_invariant_signal_distortion_ratio",
            "permutation_invariant_training", "pit_permutate", "short_time_objective_intelligibility",
            "perceptual_evaluation_speech_quality", "pit", "sdr", "si_sdr", "si_snr", "snr",
        ],
    }["metrics_tpu" if jax_root is mj else "functional"]
    assert set(pinned) <= set(names)
    for name in names:
        assert getattr(port_root, name).__name__ == getattr(jax_root, name).__name__

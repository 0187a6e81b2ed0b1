"""Deprecated short names of the port's metrics (counterpart of
``metrics_tpu/deprecated.py``). Each alias warns on construction and
otherwise is its target.
"""
import warnings
from typing import Any, Type

from metrics_tpu_torch.audio import (
    PerceptualEvaluationSpeechQuality,
    PermutationInvariantTraining,
    ScaleInvariantSignalDistortionRatio,
    ScaleInvariantSignalNoiseRatio,
    ShortTimeObjectiveIntelligibility,
    SignalDistortionRatio,
    SignalNoiseRatio,
)
from metrics_tpu_torch.classification import F1Score, FBetaScore, HingeLoss, JaccardIndex, MatthewsCorrCoef
from metrics_tpu_torch.detection import MeanAveragePrecision
from metrics_tpu_torch.image import (
    FrechetInceptionDistance,
    InceptionScore,
    KernelInceptionDistance,
    LearnedPerceptualImagePatchSimilarity,
    PeakSignalNoiseRatio,
    StructuralSimilarityIndexMeasure,
)
from metrics_tpu_torch.regression import PearsonCorrCoef, SpearmanCorrCoef


def _deprecated_alias(name: str, target: Type) -> Type:
    def __init__(self: Any, *args: Any, **kwargs: Any) -> None:  # noqa: N807
        warnings.warn(
            f"`{name}` was renamed to `{target.__name__}` in the reference API and will be"
            " removed; use the new name.",
            DeprecationWarning,
            stacklevel=2,
        )
        target.__init__(self, *args, **kwargs)

    return type(name, (target,), {"__init__": __init__, "__doc__": f"Deprecated alias of {target.__name__}."})


F1 = _deprecated_alias("F1", F1Score)
FBeta = _deprecated_alias("FBeta", FBetaScore)
Hinge = _deprecated_alias("Hinge", HingeLoss)
IoU = _deprecated_alias("IoU", JaccardIndex)
MatthewsCorrcoef = _deprecated_alias("MatthewsCorrcoef", MatthewsCorrCoef)
PearsonCorrcoef = _deprecated_alias("PearsonCorrcoef", PearsonCorrCoef)
SpearmanCorrcoef = _deprecated_alias("SpearmanCorrcoef", SpearmanCorrCoef)
PIT = _deprecated_alias("PIT", PermutationInvariantTraining)
PESQ = _deprecated_alias("PESQ", PerceptualEvaluationSpeechQuality)
STOI = _deprecated_alias("STOI", ShortTimeObjectiveIntelligibility)
SNR = _deprecated_alias("SNR", SignalNoiseRatio)
SDR = _deprecated_alias("SDR", SignalDistortionRatio)
SI_SDR = _deprecated_alias("SI_SDR", ScaleInvariantSignalDistortionRatio)
SI_SNR = _deprecated_alias("SI_SNR", ScaleInvariantSignalNoiseRatio)
PSNR = _deprecated_alias("PSNR", PeakSignalNoiseRatio)
SSIM = _deprecated_alias("SSIM", StructuralSimilarityIndexMeasure)
FID = _deprecated_alias("FID", FrechetInceptionDistance)
KID = _deprecated_alias("KID", KernelInceptionDistance)
IS = _deprecated_alias("IS", InceptionScore)
LPIPS = _deprecated_alias("LPIPS", LearnedPerceptualImagePatchSimilarity)
MAP = _deprecated_alias("MAP", MeanAveragePrecision)

__all__ = [
    "F1",
    "FBeta",
    "FID",
    "Hinge",
    "IS",
    "IoU",
    "KID",
    "LPIPS",
    "MAP",
    "MatthewsCorrcoef",
    "PESQ",
    "PIT",
    "PSNR",
    "PearsonCorrcoef",
    "SDR",
    "SI_SDR",
    "SI_SNR",
    "SNR",
    "SSIM",
    "STOI",
    "SpearmanCorrcoef",
]

"""Image metrics (counterpart of ``metrics_tpu/image/``): PSNR, SSIM and
MS-SSIM, and the embedding-based FID, KID, IS and LPIPS with their networks
(``image/networks``)."""
from metrics_tpu_torch.image.fid import FrechetInceptionDistance
from metrics_tpu_torch.image.inception import InceptionScore
from metrics_tpu_torch.image.kid import KernelInceptionDistance
from metrics_tpu_torch.image.lpip import LearnedPerceptualImagePatchSimilarity
from metrics_tpu_torch.image.psnr import PeakSignalNoiseRatio
from metrics_tpu_torch.image.ssim import MultiScaleStructuralSimilarityIndexMeasure, StructuralSimilarityIndexMeasure

__all__ = [
    "FrechetInceptionDistance",
    "InceptionScore",
    "KernelInceptionDistance",
    "LearnedPerceptualImagePatchSimilarity",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio",
    "StructuralSimilarityIndexMeasure",
]

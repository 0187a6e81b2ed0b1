"""Image quality metrics without networks (counterpart of part of
``metrics_tpu/image/``; FID, KID, IS and LPIPS need the Inception and LPIPS
networks and are not ported yet)."""
from metrics_tpu_torch.image.psnr import PeakSignalNoiseRatio
from metrics_tpu_torch.image.ssim import MultiScaleStructuralSimilarityIndexMeasure, StructuralSimilarityIndexMeasure

__all__ = [
    "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio",
    "StructuralSimilarityIndexMeasure",
]

"""Image functionals without networks (counterpart of ``metrics_tpu/functional/image/``)."""
from metrics_tpu_torch.functional.image.gradients import image_gradients
from metrics_tpu_torch.functional.image.psnr import peak_signal_noise_ratio
from metrics_tpu_torch.functional.image.ssim import (
    multiscale_structural_similarity_index_measure,
    structural_similarity_index_measure,
)

__all__ = [
    "image_gradients",
    "multiscale_structural_similarity_index_measure",
    "peak_signal_noise_ratio",
    "structural_similarity_index_measure",
]

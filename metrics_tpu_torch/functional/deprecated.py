"""Deprecated functional short names (counterpart of
``metrics_tpu/functional/deprecated.py``), with the old misspelt
``pairwise_manhatten_distance``. Each warns on call and forwards.
"""
import functools
import warnings
from typing import Any, Callable

from metrics_tpu_torch.functional.audio.pit import permutation_invariant_training
from metrics_tpu_torch.functional.audio.sdr import scale_invariant_signal_distortion_ratio, signal_distortion_ratio
from metrics_tpu_torch.functional.audio.snr import scale_invariant_signal_noise_ratio, signal_noise_ratio
from metrics_tpu_torch.functional.classification.f_beta import f1_score, fbeta_score
from metrics_tpu_torch.functional.classification.hinge import hinge_loss
from metrics_tpu_torch.functional.image.psnr import peak_signal_noise_ratio
from metrics_tpu_torch.functional.image.ssim import structural_similarity_index_measure
from metrics_tpu_torch.functional.pairwise.manhattan import pairwise_manhattan_distance


def _deprecated_fn(name: str, target: Callable) -> Callable:
    @functools.wraps(target)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        warnings.warn(
            f"`{name}` was renamed to `{target.__name__}` in the reference API and will be"
            " removed; use the new name.",
            DeprecationWarning,
            stacklevel=2,
        )
        return target(*args, **kwargs)

    wrapper.__name__ = name
    return wrapper


f1 = _deprecated_fn("f1", f1_score)
fbeta = _deprecated_fn("fbeta", fbeta_score)
hinge = _deprecated_fn("hinge", hinge_loss)
pit = _deprecated_fn("pit", permutation_invariant_training)
psnr = _deprecated_fn("psnr", peak_signal_noise_ratio)
sdr = _deprecated_fn("sdr", signal_distortion_ratio)
si_sdr = _deprecated_fn("si_sdr", scale_invariant_signal_distortion_ratio)
si_snr = _deprecated_fn("si_snr", scale_invariant_signal_noise_ratio)
snr = _deprecated_fn("snr", signal_noise_ratio)
ssim = _deprecated_fn("ssim", structural_similarity_index_measure)
pairwise_manhatten_distance = _deprecated_fn("pairwise_manhatten_distance", pairwise_manhattan_distance)

__all__ = [
    "f1",
    "fbeta",
    "hinge",
    "pairwise_manhatten_distance",
    "pit",
    "psnr",
    "sdr",
    "si_sdr",
    "si_snr",
    "snr",
    "ssim",
]

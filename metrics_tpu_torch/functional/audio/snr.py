"""SNR and SI-SNR (counterpart of ``metrics_tpu/functional/audio/snr.py``):
reductions over the trailing time axis."""
import torch

from metrics_tpu_torch.functional.audio.sdr import _as_float, scale_invariant_signal_distortion_ratio
from metrics_tpu_torch.utils.checks import _check_same_shape


def signal_noise_ratio(preds: torch.Tensor, target: torch.Tensor, zero_mean: bool = False) -> torch.Tensor:
    """SNR = 10 log10(||target||^2 / ||target - preds||^2), shape ``[..., time] -> [...]``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import signal_noise_ratio
        >>> target = torch.sin(torch.arange(100) / 5.0)
        >>> print(round(float(signal_noise_ratio(target + 0.1, target)), 4))
        16.8721
    """
    preds, target = _as_float(preds, target)
    _check_same_shape(preds, target)
    eps = torch.finfo(preds.dtype).eps

    if zero_mean:
        target = target - target.mean(dim=-1, keepdim=True)
        preds = preds - preds.mean(dim=-1, keepdim=True)

    noise = target - preds
    snr_value = (torch.sum(target**2, dim=-1) + eps) / (torch.sum(noise**2, dim=-1) + eps)
    return 10 * torch.log10(snr_value)


def scale_invariant_signal_noise_ratio(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """SI-SNR: SI-SDR with the means subtracted.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import scale_invariant_signal_noise_ratio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> print(round(float(scale_invariant_signal_noise_ratio(preds, target)), 4))
        15.0918
    """
    return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=True)

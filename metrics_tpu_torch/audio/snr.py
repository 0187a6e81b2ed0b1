"""SNR and SI-SNR modules (counterpart of ``metrics_tpu/audio/snr.py``)."""
from typing import Any

import torch

from metrics_tpu_torch.functional.audio.snr import scale_invariant_signal_noise_ratio, signal_noise_ratio
from metrics_tpu_torch.metric import Metric


class SignalNoiseRatio(Metric):
    """Streaming mean SNR over all seen signals (states ``sum_snr`` and ``total``).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SignalNoiseRatio
        >>> target = torch.sin(torch.arange(100) / 5.0)
        >>> snr = SignalNoiseRatio(device="cpu")
        >>> print(round(float(snr(target + 0.1, target)), 4))
        16.8721
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean
        self.add_state("sum_snr", default=0.0, dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        snr_batch = signal_noise_ratio(preds=preds, target=target, zero_mean=self.zero_mean)
        self.sum_snr = self.sum_snr + snr_batch.sum()
        self.total = self.total + snr_batch.numel()

    def compute(self) -> torch.Tensor:
        return self.sum_snr / self.total


class ScaleInvariantSignalNoiseRatio(Metric):
    """Streaming mean SI-SNR (states ``sum_si_snr`` and ``total``).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ScaleInvariantSignalNoiseRatio
        >>> target = torch.sin(torch.arange(200) / 7.0)
        >>> noise = torch.cos(torch.arange(200) / 3.0)
        >>> si_snr = ScaleInvariantSignalNoiseRatio(device="cpu")
        >>> print(round(float(si_snr(target + 0.1 * noise, target)), 4))
        19.8763
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_si_snr", default=0.0, dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        si_snr_batch = scale_invariant_signal_noise_ratio(preds=preds, target=target)
        self.sum_si_snr = self.sum_si_snr + si_snr_batch.sum()
        self.total = self.total + si_snr_batch.numel()

    def compute(self) -> torch.Tensor:
        return self.sum_si_snr / self.total

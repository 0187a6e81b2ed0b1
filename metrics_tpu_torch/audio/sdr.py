"""SDR and SI-SDR modules (counterpart of ``metrics_tpu/audio/sdr.py``)."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.audio.sdr import scale_invariant_signal_distortion_ratio, signal_distortion_ratio
from metrics_tpu_torch.metric import Metric


class SignalDistortionRatio(Metric):
    """Streaming mean filter-invariant SDR (states ``sum_sdr`` and ``total``).
    The arguments are :func:`~metrics_tpu_torch.functional.signal_distortion_ratio`'s.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SignalDistortionRatio
        >>> target = torch.sin(torch.arange(200) / 7.0)
        >>> noise = torch.cos(torch.arange(200) / 3.0)
        >>> sdr = SignalDistortionRatio(device="cpu")
        >>> print(round(float(sdr((target + 0.1 * noise)[None], target[None])), 2))
        22.47
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(
        self,
        use_cg_iter: Optional[int] = None,
        filter_length: int = 512,
        zero_mean: bool = False,
        load_diag: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.use_cg_iter = use_cg_iter
        self.filter_length = filter_length
        self.zero_mean = zero_mean
        self.load_diag = load_diag
        self.add_state("sum_sdr", default=0.0, dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        sdr_batch = signal_distortion_ratio(
            preds, target, self.use_cg_iter, self.filter_length, self.zero_mean, self.load_diag
        )
        self.sum_sdr = self.sum_sdr + sdr_batch.sum()
        self.total = self.total + sdr_batch.numel()

    def compute(self) -> torch.Tensor:
        return self.sum_sdr / self.total


class ScaleInvariantSignalDistortionRatio(Metric):
    """Streaming mean SI-SDR (states ``sum_si_sdr`` and ``total``).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ScaleInvariantSignalDistortionRatio
        >>> target = torch.sin(torch.arange(200) / 7.0)
        >>> noise = torch.cos(torch.arange(200) / 3.0)
        >>> si_sdr = ScaleInvariantSignalDistortionRatio(device="cpu")
        >>> print(round(float(si_sdr(target + 0.1 * noise, target)), 4))
        19.9175
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean
        self.add_state("sum_si_sdr", default=0.0, dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        si_sdr_batch = scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=self.zero_mean)
        self.sum_si_sdr = self.sum_si_sdr + si_sdr_batch.sum()
        self.total = self.total + si_sdr_batch.numel()

    def compute(self) -> torch.Tensor:
        return self.sum_si_sdr / self.total

"""CalibrationError module metric (counterpart of
``metrics_tpu/classification/calibration_error.py``).

By default it buffers every sample's top-1 confidence and correctness and
bins them at ``compute``. ``streaming_bins=True`` keeps O(n_bins) state
instead: each update bins its samples through the ``binned_calibration``
kernel into per-bin ``(count, conf_sum, acc_sum)`` sums, and ``compute``
recovers the same per-bin means (float sums: equal within float32
summation order).
"""
from typing import Any

import torch

from metrics_tpu_torch.functional.classification.calibration_error import (
    _bin_boundaries,
    _ce_compute,
    _ce_compute_from_sums,
    _ce_update,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops.binned_counts import binned_calibration_counts
from metrics_tpu_torch.utils.data import dim_zero_cat


class CalibrationError(Metric):
    """Top-label calibration error.

    Args:
        n_bins: number of equal-width confidence bins over (0, 1].
        norm: ``l1`` (ECE), ``l2`` (RMSCE) or ``max`` (MCE).
        streaming_bins: accumulate per-bin sums at update time (O(n_bins)
            state, ``dist_reduce_fx="sum"``) through the ``binned_calibration``
            kernel instead of buffering every sample until ``compute``.
        device: see :class:`~metrics_tpu_torch.metric.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CalibrationError
        >>> ece = CalibrationError(n_bins=3, device="cpu")
        >>> print(round(float(ece(torch.tensor([0.3, 0.6, 0.9, 0.6]), torch.tensor([0, 1, 1, 0]))), 4))
        0.15
    """

    is_differentiable = False
    higher_is_better = False
    DISTANCES = {"l1", "l2", "max"}

    def __init__(self, n_bins: int = 15, norm: str = "l1", streaming_bins: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if norm not in self.DISTANCES:
            raise ValueError(f"Norm {norm} is not supported. Please select from l1, l2, or max. ")
        if not isinstance(n_bins, int) or n_bins <= 0:
            raise ValueError(f"Expected argument `n_bins` to be a int larger than 0 but got {n_bins}")
        self.n_bins = n_bins
        self.norm = norm
        self.streaming_bins = streaming_bins
        self.register_buffer("bin_boundaries", _bin_boundaries(n_bins, self.device), persistent=False)
        if streaming_bins:
            for name in ("bin_count", "bin_conf", "bin_acc"):
                self.add_state(name, torch.zeros(n_bins, dtype=torch.float32), dist_reduce_fx="sum")
            self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        else:
            self.add_state("confidences", [], dist_reduce_fx="cat", placeholder=torch.get_default_dtype())
            self.add_state("accuracies", [], dist_reduce_fx="cat", placeholder=torch.get_default_dtype())

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        confidences, accuracies = _ce_update(preds, target)
        if self.streaming_bins:
            count, conf_sum, acc_sum = binned_calibration_counts(confidences, accuracies, self.bin_boundaries)
            self.bin_count = self.bin_count + count
            self.bin_conf = self.bin_conf + conf_sum
            self.bin_acc = self.bin_acc + acc_sum
            self.total = self.total + confidences.shape[0]
        else:
            self.confidences.append(confidences)
            self.accuracies.append(accuracies)

    def compute(self) -> torch.Tensor:
        if self.streaming_bins:
            return _ce_compute_from_sums(self.bin_count, self.bin_conf, self.bin_acc, self.total, norm=self.norm)
        confidences = dim_zero_cat(self.confidences)
        accuracies = dim_zero_cat(self.accuracies)
        return _ce_compute(confidences, accuracies, self.bin_boundaries, norm=self.norm)

"""Top-label calibration error (counterpart of
``metrics_tpu/functional/classification/calibration_error.py``).

Bin ``i`` covers ``(b[i], b[i+1]]``; a confidence at or below ``b[0]`` falls
in no bin, one above ``b[-1]`` or NaN in the last bin. The binning is the
``binned_calibration`` op, so the buffered and the streaming
``CalibrationError`` bin alike.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.ops.binned_counts import binned_calibration_counts
from metrics_tpu_torch.ops.safe_ops import safe_divide
from metrics_tpu_torch.utils.checks import _input_format_classification
from metrics_tpu_torch.utils.data import _linspace
from metrics_tpu_torch.utils.enums import DataType


def _bin_boundaries(n_bins: int, device=None) -> torch.Tensor:
    return _linspace(0.0, 1.0, n_bins + 1, dtype=torch.float32, device=device)


def _binning_bucketize(
    confidences: torch.Tensor, accuracies: torch.Tensor, bin_boundaries: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-bin mean confidence, mean accuracy and share of the samples."""
    count, conf_sum, acc_sum = binned_calibration_counts(confidences, accuracies, bin_boundaries)
    count = count.to(torch.float32)
    return safe_divide(conf_sum, count), safe_divide(acc_sum, count), count / confidences.shape[0]


def _ce_from_bins(conf_bin: torch.Tensor, acc_bin: torch.Tensor, prop_bin: torch.Tensor, norm: str) -> torch.Tensor:
    """The norm of the per-bin gaps."""
    if norm == "l1":
        return torch.sum(torch.abs(acc_bin - conf_bin) * prop_bin)
    if norm == "max":
        return torch.max(torch.abs(acc_bin - conf_bin))
    ce = torch.sum((acc_bin - conf_bin) ** 2 * prop_bin)
    return torch.where(ce > 0, torch.sqrt(torch.where(ce > 0, ce, torch.ones_like(ce))), torch.zeros_like(ce))


def _check_norm(norm: str) -> None:
    if norm not in {"l1", "l2", "max"}:
        raise ValueError(f"Norm {norm} is not supported. Please select from l1, l2, or max. ")


def _ce_compute(
    confidences: torch.Tensor,
    accuracies: torch.Tensor,
    bin_boundaries: torch.Tensor,
    norm: str = "l1",
) -> torch.Tensor:
    """``l1`` (ECE), ``l2`` (RMSCE) or ``max`` (MCE) over buffered samples."""
    _check_norm(norm)
    conf_bin, acc_bin, prop_bin = _binning_bucketize(confidences, accuracies, bin_boundaries)
    return _ce_from_bins(conf_bin, acc_bin, prop_bin, norm)


def _ce_compute_from_sums(
    count_bin: torch.Tensor,
    conf_sum: torch.Tensor,
    acc_sum: torch.Tensor,
    total: torch.Tensor,
    norm: str = "l1",
) -> torch.Tensor:
    """The ``_ce_compute`` norms from streamed per-bin ``(count, conf_sum, acc_sum)`` and the sample total."""
    _check_norm(norm)
    return _ce_from_bins(safe_divide(conf_sum, count_bin), safe_divide(acc_sum, count_bin), count_bin / total, norm)


def _ce_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 confidence and correctness per sample, float32."""
    _, _, mode = _input_format_classification(preds, target)
    if mode == DataType.BINARY:
        confidences, accuracies = preds, target
    elif mode == DataType.MULTICLASS:
        confidences = preds.amax(dim=1)
        accuracies = preds.argmax(dim=1) == target
    elif mode == DataType.MULTIDIM_MULTICLASS:
        flat = preds.transpose(1, -1).reshape(-1, preds.shape[1])
        confidences = flat.amax(dim=1)
        accuracies = flat.argmax(dim=1) == target.reshape(-1)
    else:
        raise ValueError(
            f"Calibration error is not well-defined for data with size {tuple(preds.shape)} and targets {tuple(target.shape)}."
        )
    return confidences.to(torch.float32), accuracies.to(torch.float32)


def calibration_error(preds: torch.Tensor, target: torch.Tensor, n_bins: int = 15, norm: str = "l1") -> torch.Tensor:
    """Top-label calibration error over ``n_bins`` equal-width bins of (0, 1].

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import calibration_error
        >>> preds = torch.tensor([0.25, 0.25, 0.55, 0.75, 0.75])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> print(round(float(calibration_error(preds, target, n_bins=3)), 4))
        0.29
    """
    if norm not in ("l1", "l2", "max"):
        raise ValueError(f"Argument `norm` is expected to be one of 'l1', 'l2', 'max' but got {norm}")
    if not isinstance(n_bins, int) or n_bins <= 0:
        raise ValueError(f"Argument `n_bins` expected to be a int larger than 0 but got {n_bins}")
    confidences, accuracies = _ce_update(preds, target)
    return _ce_compute(confidences, accuracies, _bin_boundaries(n_bins, confidences.device), norm=norm)

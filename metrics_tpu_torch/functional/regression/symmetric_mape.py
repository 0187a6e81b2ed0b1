"""Symmetric mean absolute percentage error (counterpart of
``metrics_tpu/functional/regression/symmetric_mape.py``)."""
from typing import Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape


def _symmetric_mean_absolute_percentage_error_update(
    preds: torch.Tensor, target: torch.Tensor, epsilon: float = 1.17e-06
) -> Tuple[torch.Tensor, int]:
    _check_same_shape(preds, target)
    abs_per_error = (preds - target).abs() / (target.abs() + preds.abs()).clamp(min=epsilon)
    return 2 * abs_per_error.sum(), target.numel()


def _symmetric_mean_absolute_percentage_error_compute(
    sum_abs_per_error: torch.Tensor, num_obs: Union[int, torch.Tensor]
) -> torch.Tensor:
    return sum_abs_per_error / num_obs


def symmetric_mean_absolute_percentage_error(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Symmetric mean absolute percentage error (``2*|y-ŷ| / (|y|+|ŷ|)`` averaged).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import symmetric_mean_absolute_percentage_error
        >>> print(round(float(symmetric_mean_absolute_percentage_error(torch.tensor([1.0, 2.0, 3.0]), torch.tensor([1.0, 4.0, 3.0]))), 4))
        0.2222
    """
    sum_abs_per_error, num_obs = _symmetric_mean_absolute_percentage_error_update(preds, target)
    return _symmetric_mean_absolute_percentage_error_compute(sum_abs_per_error, num_obs)

"""Mean absolute percentage error (counterpart of
``metrics_tpu/functional/regression/mape.py``); the epsilon is sklearn's."""
from typing import Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape


def _mean_absolute_percentage_error_update(
    preds: torch.Tensor, target: torch.Tensor, epsilon: float = 1.17e-06
) -> Tuple[torch.Tensor, int]:
    _check_same_shape(preds, target)
    abs_per_error = (preds - target).abs() / target.abs().clamp(min=epsilon)
    return abs_per_error.sum(), target.numel()


def _mean_absolute_percentage_error_compute(sum_abs_per_error: torch.Tensor, num_obs: Union[int, torch.Tensor]) -> torch.Tensor:
    return sum_abs_per_error / num_obs


def mean_absolute_percentage_error(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute percentage error.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import mean_absolute_percentage_error
        >>> print(round(float(mean_absolute_percentage_error(torch.tensor([1.0, 2.0, 3.0]), torch.tensor([1.0, 4.0, 3.0]))), 4))
        0.1667
    """
    sum_abs_per_error, num_obs = _mean_absolute_percentage_error_update(preds, target)
    return _mean_absolute_percentage_error_compute(sum_abs_per_error, num_obs)

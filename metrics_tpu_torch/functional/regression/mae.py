"""Mean absolute error (counterpart of ``metrics_tpu/functional/regression/mae.py``)."""
from typing import Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape


def _mean_absolute_error_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, int]:
    _check_same_shape(preds, target)
    return (preds - target).abs().sum(), target.numel()


def _mean_absolute_error_compute(sum_abs_error: torch.Tensor, n_obs: Union[int, torch.Tensor]) -> torch.Tensor:
    return sum_abs_error / n_obs


def mean_absolute_error(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute error.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import mean_absolute_error
        >>> print(round(float(mean_absolute_error(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))), 4))
        0.5
    """
    sum_abs_error, n_obs = _mean_absolute_error_update(preds, target)
    return _mean_absolute_error_compute(sum_abs_error, n_obs)

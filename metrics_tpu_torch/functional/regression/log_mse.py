"""Mean squared log error (counterpart of ``metrics_tpu/functional/regression/log_mse.py``)."""
from typing import Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape


def _mean_squared_log_error_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, int]:
    _check_same_shape(preds, target)
    return ((torch.log1p(preds) - torch.log1p(target)) ** 2).sum(), target.numel()


def _mean_squared_log_error_compute(sum_squared_log_error: torch.Tensor, n_obs: Union[int, torch.Tensor]) -> torch.Tensor:
    return sum_squared_log_error / n_obs


def mean_squared_log_error(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared logarithmic error.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import mean_squared_log_error
        >>> print(round(float(mean_squared_log_error(torch.tensor([0.5, 1.0, 2.0]), torch.tensor([0.5, 2.0, 2.0]))), 4))
        0.0548
    """
    sum_squared_log_error, n_obs = _mean_squared_log_error_update(preds, target)
    return _mean_squared_log_error_compute(sum_squared_log_error, n_obs)

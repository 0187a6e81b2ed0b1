"""Mean squared error (counterpart of ``metrics_tpu/functional/regression/mse.py``)."""
from typing import Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape


def _mean_squared_error_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, int]:
    _check_same_shape(preds, target)
    diff = preds - target
    return (diff * diff).sum(), target.numel()


def _mean_squared_error_compute(
    sum_squared_error: torch.Tensor, n_obs: Union[int, torch.Tensor], squared: bool = True
) -> torch.Tensor:
    mse = sum_squared_error / n_obs
    return mse if squared else torch.sqrt(mse)


def mean_squared_error(preds: torch.Tensor, target: torch.Tensor, squared: bool = True) -> torch.Tensor:
    """Mean squared error; RMSE when ``squared=False``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import mean_squared_error
        >>> print(round(float(mean_squared_error(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))), 4))
        0.375
    """
    sum_squared_error, n_obs = _mean_squared_error_update(preds, target)
    return _mean_squared_error_compute(sum_squared_error, n_obs, squared=squared)

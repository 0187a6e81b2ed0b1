"""MeanSquaredLogError module metric (counterpart of ``metrics_tpu/regression/log_mse.py``)."""
from typing import Any

import torch

from metrics_tpu_torch.functional.regression.log_mse import _mean_squared_log_error_update, _mean_squared_log_error_compute
from metrics_tpu_torch.metric import Metric


class MeanSquaredLogError(Metric):
    """Mean squared logarithmic error.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanSquaredLogError
        >>> metric = MeanSquaredLogError(device="cpu")
        >>> print(round(float(metric(torch.tensor([1.0, 2.0]), torch.tensor([1.5, 2.5]))), 4))
        0.0368
    """

    is_differentiable = True
    higher_is_better = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_squared_log_error", default=0.0, dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        value, n_obs = _mean_squared_log_error_update(preds, target)
        self.sum_squared_log_error = self.sum_squared_log_error + value
        self.total = self.total + n_obs

    def compute(self) -> torch.Tensor:
        return _mean_squared_log_error_compute(self.sum_squared_log_error, self.total)

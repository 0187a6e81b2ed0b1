"""MeanAbsolutePercentageError module metric (counterpart of ``metrics_tpu/regression/mape.py``)."""
from typing import Any

import torch

from metrics_tpu_torch.functional.regression.mape import _mean_absolute_percentage_error_update, _mean_absolute_percentage_error_compute
from metrics_tpu_torch.metric import Metric


class MeanAbsolutePercentageError(Metric):
    """Mean absolute percentage error.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanAbsolutePercentageError
        >>> metric = MeanAbsolutePercentageError(device="cpu")
        >>> print(round(float(metric(torch.tensor([2.0, 4.0]), torch.tensor([1.0, 5.0]))), 4))
        0.6
    """

    is_differentiable = True
    higher_is_better = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_per_error", default=0.0, dist_reduce_fx="sum")
        self.add_state("total", default=0.0, dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        value, n_obs = _mean_absolute_percentage_error_update(preds, target)
        self.sum_abs_per_error = self.sum_abs_per_error + value
        self.total = self.total + n_obs

    def compute(self) -> torch.Tensor:
        return _mean_absolute_percentage_error_compute(self.sum_abs_per_error, self.total)

"""MeanAbsoluteError module metric (counterpart of ``metrics_tpu/regression/mae.py``)."""
from typing import Any

import torch

from metrics_tpu_torch.functional.regression.mae import _mean_absolute_error_compute, _mean_absolute_error_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops.safe_ops import kahan_add


class MeanAbsoluteError(Metric):
    """Mean absolute error.

    Args:
        compensated: Kahan-compensate the running absolute-error sum (see
            :class:`~metrics_tpu_torch.MeanSquaredError`).
        device: see :class:`~metrics_tpu_torch.metric.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanAbsoluteError
        >>> mae = MeanAbsoluteError(device="cpu")
        >>> print(round(float(mae(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))), 4))
        0.5
    """

    is_differentiable = True
    higher_is_better = False

    # row-additive error sums and element counts: eligible for `jit_bucket`
    # padding and the compiled "mask", except under the Kahan carry, whose
    # result depends on the order of the additions
    @property
    def _batch_additive(self) -> bool:
        return not getattr(self, "compensated", False)

    def __init__(self, compensated: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.compensated = compensated
        self.add_state("sum_abs_error", default=0.0, dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")
        if compensated:
            self.add_state("sum_abs_error_comp", default=0.0, dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        sum_abs_error, n_obs = _mean_absolute_error_update(preds, target)
        if self.compensated:
            self.sum_abs_error, self.sum_abs_error_comp = kahan_add(self.sum_abs_error, self.sum_abs_error_comp, sum_abs_error)
        else:
            self.sum_abs_error = self.sum_abs_error + sum_abs_error
        self.total = self.total + n_obs

    def compute(self) -> torch.Tensor:
        return _mean_absolute_error_compute(self.sum_abs_error, self.total)

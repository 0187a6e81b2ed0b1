"""PearsonCorrCoef module metric (counterpart of ``metrics_tpu/regression/pearson.py``)."""
from typing import Any

import torch

from metrics_tpu_torch.functional.regression.pearson import (
    _final_aggregation,
    _pearson_corrcoef_compute,
    _pearson_corrcoef_update,
)
from metrics_tpu_torch.metric import Metric


class PearsonCorrCoef(Metric):
    """Pearson correlation coefficient over a stream of 1-D batches.

    The states are running moments with ``dist_reduce_fx=None``: a sync
    stacks each replica's statistics, and ``compute`` merges a stacked form
    with the parallel-variance identity.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import PearsonCorrCoef
        >>> pearson = PearsonCorrCoef(device="cpu")
        >>> print(round(float(pearson(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))), 4))
        0.9849
    """

    is_differentiable = True
    higher_is_better = None  # both -1 and 1 are optimal
    full_state_update = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        for name in ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total"):
            self.add_state(name, default=0.0, dist_reduce_fx=None)

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total = _pearson_corrcoef_update(
            preds, target, self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total
        )

    def compute(self) -> torch.Tensor:
        if self.mean_x.ndim >= 1 and self.mean_x.numel() > 1:  # stacked per-replica statistics
            var_x, var_y, corr_xy, n_total = _final_aggregation(
                self.mean_x, self.mean_y, self.var_x, self.var_y, self.corr_xy, self.n_total
            )
        else:
            var_x, var_y, corr_xy, n_total = self.var_x, self.var_y, self.corr_xy, self.n_total
        return _pearson_corrcoef_compute(var_x, var_y, corr_xy, n_total)

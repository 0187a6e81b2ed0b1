"""R2Score module metric (counterpart of ``metrics_tpu/regression/r2.py``)."""
from typing import Any

import torch

from metrics_tpu_torch.functional.regression.r2 import _ALLOWED_MULTIOUTPUT, _r2_score_compute, _r2_score_update
from metrics_tpu_torch.metric import Metric


class R2Score(Metric):
    """R² score with per-output streaming sums.

    Args:
        num_outputs: outputs per sample; the sums register as
            ``[num_outputs]`` and grow to the inputs' width if it is larger.
        adjusted: number of independent regressors of the adjusted score
            (0: the plain score).
        multioutput: ``raw_values``, ``uniform_average`` or
            ``variance_weighted``.
        device: see :class:`~metrics_tpu_torch.metric.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import R2Score
        >>> r2 = R2Score(device="cpu")
        >>> print(round(float(r2(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))), 4))
        0.9486
    """

    is_differentiable = True
    higher_is_better = True
    # the sums grow to the inputs' output width when it exceeds num_outputs
    _shape_polymorphic_states = frozenset({"sum_squared_error", "sum_error", "residual"})

    def __init__(
        self, num_outputs: int = 1, adjusted: int = 0, multioutput: str = "uniform_average", **kwargs: Any
    ) -> None:
        super().__init__(**kwargs)
        self.num_outputs = num_outputs
        if adjusted < 0 or not isinstance(adjusted, int):
            raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
        self.adjusted = adjusted
        if multioutput not in _ALLOWED_MULTIOUTPUT:
            raise ValueError(f"Invalid input to argument `multioutput`. Choose one of the following: {_ALLOWED_MULTIOUTPUT}")
        self.multioutput = multioutput
        self.add_state("sum_squared_error", default=torch.zeros(num_outputs), dist_reduce_fx="sum")
        self.add_state("sum_error", default=torch.zeros(num_outputs), dist_reduce_fx="sum")
        self.add_state("residual", default=torch.zeros(num_outputs), dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        sum_squared_obs, sum_obs, rss, n_obs = _r2_score_update(preds, target)
        self.sum_squared_error = self.sum_squared_error + sum_squared_obs
        self.sum_error = self.sum_error + sum_obs
        self.residual = self.residual + rss
        self.total = self.total + n_obs

    def compute(self) -> torch.Tensor:
        return _r2_score_compute(
            self.sum_squared_error, self.sum_error, self.residual, self.total, self.adjusted, self.multioutput
        )

"""ExplainedVariance module metric (counterpart of ``metrics_tpu/regression/explained_variance.py``)."""
from typing import Any

import torch

from metrics_tpu_torch.functional.regression.explained_variance import (
    _ALLOWED_MULTIOUTPUT,
    _explained_variance_compute,
    _explained_variance_update,
)
from metrics_tpu_torch.metric import Metric


class ExplainedVariance(Metric):
    """Explained variance with streaming sum states (scalars that take the
    inputs' output width at the first multi-output update).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ExplainedVariance
        >>> ev = ExplainedVariance(device="cpu")
        >>> print(round(float(ev(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))), 4))
        0.9572
    """

    is_differentiable = True
    higher_is_better = True
    # a multi-output update turns the scalar sums into [num_outputs]
    _shape_polymorphic_states = frozenset({"sum_error", "sum_squared_error", "sum_target", "sum_squared_target"})

    def __init__(self, multioutput: str = "uniform_average", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if multioutput not in _ALLOWED_MULTIOUTPUT:
            raise ValueError(f"Invalid input to argument `multioutput`. Choose one of the following: {_ALLOWED_MULTIOUTPUT}")
        self.multioutput = multioutput
        for name in ("sum_error", "sum_squared_error", "sum_target", "sum_squared_target", "n_obs"):
            self.add_state(name, default=0.0, dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        n_obs, sum_error, sum_squared_error, sum_target, sum_squared_target = _explained_variance_update(preds, target)
        self.n_obs = self.n_obs + n_obs
        self.sum_error = self.sum_error + sum_error
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.sum_target = self.sum_target + sum_target
        self.sum_squared_target = self.sum_squared_target + sum_squared_target

    def compute(self) -> torch.Tensor:
        return _explained_variance_compute(
            self.n_obs, self.sum_error, self.sum_squared_error, self.sum_target, self.sum_squared_target, self.multioutput
        )

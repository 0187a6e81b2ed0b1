"""TweedieDevianceScore module metric (counterpart of ``metrics_tpu/regression/tweedie_deviance.py``)."""
from typing import Any

import torch

from metrics_tpu_torch.functional.regression.tweedie_deviance import (
    _tweedie_deviance_score_compute,
    _tweedie_deviance_score_update,
)
from metrics_tpu_torch.metric import Metric


class TweedieDevianceScore(Metric):
    """Tweedie deviance score (power 0 is MSE, 1 Poisson, 2 Gamma, others compound).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import TweedieDevianceScore
        >>> tweedie = TweedieDevianceScore(power=1.0, device="cpu")
        >>> print(round(float(tweedie(torch.tensor([2.0, 4.0]), torch.tensor([1.0, 5.0]))), 4))
        0.4226
    """

    is_differentiable = True
    higher_is_better = False

    def __init__(self, power: float = 0.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if 0 < power < 1:
            raise ValueError(f"Deviance Score is not defined for power={power}.")
        self.power = power
        self.add_state("sum_deviance_score", default=0.0, dist_reduce_fx="sum")
        self.add_state("num_observations", default=0, dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, targets: torch.Tensor) -> None:
        sum_deviance_score, num_observations = _tweedie_deviance_score_update(preds, targets, self.power)
        self.sum_deviance_score = self.sum_deviance_score + sum_deviance_score
        self.num_observations = self.num_observations + num_observations

    def compute(self) -> torch.Tensor:
        return _tweedie_deviance_score_compute(self.sum_deviance_score, self.num_observations)

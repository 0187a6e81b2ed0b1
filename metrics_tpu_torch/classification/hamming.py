"""HammingDistance module metric (counterpart of ``metrics_tpu/classification/hamming.py``)."""
from typing import Any

import torch

from metrics_tpu_torch.functional.classification.hamming import _hamming_distance_compute, _hamming_distance_update
from metrics_tpu_torch.metric import Metric


class HammingDistance(Metric):
    """Fraction of wrong labels over all labels seen.

    Args:
        threshold: probability cutoff that binarizes probabilistic/logit inputs.
        kwargs: see :class:`~metrics_tpu_torch.metric.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import HammingDistance
        >>> hamming = HammingDistance(device="cpu")
        >>> print(round(float(hamming(torch.tensor([[0, 1], [1, 1]]), torch.tensor([[0, 1], [0, 1]]))), 4))
        0.25
    """

    is_differentiable = False
    higher_is_better = False

    def __init__(self, threshold: float = 0.5, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("correct", default=torch.tensor(0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0), dist_reduce_fx="sum")
        self.threshold = threshold

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        correct, total = _hamming_distance_update(preds, target, self.threshold)
        self.correct = self.correct + correct
        self.total = self.total + total

    def compute(self) -> torch.Tensor:
        return _hamming_distance_compute(self.correct, self.total)

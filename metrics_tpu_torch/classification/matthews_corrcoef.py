"""MatthewsCorrCoef module metric (counterpart of ``metrics_tpu/classification/matthews_corrcoef.py``)."""
from typing import Any

import torch

from metrics_tpu_torch.functional.classification.matthews_corrcoef import (
    _matthews_corrcoef_compute,
    _matthews_corrcoef_update,
)
from metrics_tpu_torch.metric import Metric


class MatthewsCorrCoef(Metric):
    """Matthews correlation coefficient over a streaming ``[C, C]`` confusion
    matrix (int64 here, int32 in the JAX package; values agree).

    Args:
        num_classes: number of classes C.
        threshold: probability cutoff binarizing probabilistic inputs.
        kwargs: see :class:`~metrics_tpu_torch.metric.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MatthewsCorrCoef
        >>> mcc = MatthewsCorrCoef(num_classes=2, device="cpu")
        >>> print(round(float(mcc(torch.tensor([0, 1, 0, 1]), torch.tensor([0, 1, 1, 1]))), 4))
        0.5774
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(self, num_classes: int, threshold: float = 0.5, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.threshold = threshold
        self.add_state("confmat", default=torch.zeros((num_classes, num_classes), dtype=torch.int64), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        self.confmat = self.confmat + _matthews_corrcoef_update(preds, target, self.num_classes, self.threshold)

    def compute(self) -> torch.Tensor:
        return _matthews_corrcoef_compute(self.confmat)

"""CohenKappa module metric (counterpart of ``metrics_tpu/classification/cohen_kappa.py``)."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.classification.cohen_kappa import _cohen_kappa_compute, _cohen_kappa_update
from metrics_tpu_torch.metric import Metric


class CohenKappa(Metric):
    """Cohen's kappa over a streaming ``[C, C]`` confusion matrix.

    The state counts in int64 (the JAX package's is int32; values agree).

    Args:
        num_classes: number of classes C.
        weights: ``None``/``"none"``, ``"linear"`` or ``"quadratic"``.
        threshold: probability cutoff binarizing probabilistic inputs.
        kwargs: see :class:`~metrics_tpu_torch.metric.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CohenKappa
        >>> kappa = CohenKappa(num_classes=2, device="cpu")
        >>> print(round(float(kappa(torch.tensor([0, 1, 0, 1]), torch.tensor([0, 1, 1, 1]))), 4))
        0.5
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(self, num_classes: int, weights: Optional[str] = None, threshold: float = 0.5, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.weights = weights
        self.threshold = threshold
        allowed_weights = ("linear", "quadratic", "none", None)
        if weights not in allowed_weights:
            raise ValueError(f"Argument weights needs to one of the following: {allowed_weights}")
        self.add_state("confmat", default=torch.zeros((num_classes, num_classes), dtype=torch.int64), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        self.confmat = self.confmat + _cohen_kappa_update(preds, target, self.num_classes, self.threshold)

    def compute(self) -> torch.Tensor:
        return _cohen_kappa_compute(self.confmat, None if self.weights == "none" else self.weights)

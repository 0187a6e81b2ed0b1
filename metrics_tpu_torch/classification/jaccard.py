"""JaccardIndex module metric (counterpart of ``metrics_tpu/classification/jaccard.py``)."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.classification.confusion_matrix import ConfusionMatrix
from metrics_tpu_torch.functional.classification.jaccard import _jaccard_from_confmat


class JaccardIndex(ConfusionMatrix):
    """Intersection over union (mIoU) from a streaming int64 confusion matrix.

    Args:
        num_classes: number of classes C.
        ignore_index: a class whose row is zeroed and whose score is dropped
            (a void label); out of ``[0, C)`` it does nothing.
        absent_score: the score of a class with an empty union.
        threshold: probability cutoff binarizing probabilistic inputs.
        reduction: ``"elementwise_mean"``, ``"sum"`` or ``"none"``/``None``
            (per-class scores).
        kwargs: see :class:`~metrics_tpu_torch.metric.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import JaccardIndex
        >>> jaccard = JaccardIndex(num_classes=2, device="cpu")
        >>> print(round(float(jaccard(torch.tensor([0, 1, 0, 1]), torch.tensor([0, 1, 1, 1]))), 4))
        0.5833
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(
        self,
        num_classes: int,
        ignore_index: Optional[int] = None,
        absent_score: float = 0.0,
        threshold: float = 0.5,
        reduction: str = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes=num_classes, normalize=None, threshold=threshold, multilabel=False, **kwargs)
        self.reduction = reduction
        self.ignore_index = ignore_index
        self.absent_score = absent_score

    def compute(self) -> torch.Tensor:
        return _jaccard_from_confmat(self.confmat, self.num_classes, self.ignore_index, self.absent_score, self.reduction)

"""Jaccard index, IoU (counterpart of ``metrics_tpu/functional/classification/jaccard.py``).

The update is the confusion matrix's (the ``confusion_counts`` kernel).
``ignore_index`` zeroes its row and drops its class at indices known before
the program runs, so the compute captures."""
from typing import Optional

import torch

from metrics_tpu_torch.functional.classification.confusion_matrix import _confusion_matrix_update
from metrics_tpu_torch.ops.safe_ops import safe_divide
from metrics_tpu_torch.parallel.comm import reduce


def _jaccard_from_confmat(
    confmat: torch.Tensor,
    num_classes: int,
    ignore_index: Optional[int] = None,
    absent_score: float = 0.0,
    reduction: str = "elementwise_mean",
) -> torch.Tensor:
    """Per-class intersection over union of a ``[C, C]`` confusion matrix,
    reduced by ``reduction``; a class with an empty union scores ``absent_score``."""
    drop = ignore_index is not None and 0 <= ignore_index < num_classes
    if drop:
        confmat = confmat.clone()
        confmat[ignore_index] = 0

    intersection = torch.diagonal(confmat)
    union = confmat.sum(dim=0) + confmat.sum(dim=1) - intersection

    scores = safe_divide(intersection.to(torch.float32), union.to(torch.float32))
    scores = torch.where(union == 0, absent_score, scores)

    if drop:
        scores = torch.cat([scores[:ignore_index], scores[ignore_index + 1 :]])
    return reduce(scores, reduction=reduction)


def jaccard_index(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    ignore_index: Optional[int] = None,
    absent_score: float = 0.0,
    threshold: float = 0.5,
    reduction: str = "elementwise_mean",
) -> torch.Tensor:
    """Jaccard index ``|A ∩ B| / |A ∪ B|`` per class of one batch.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import jaccard_index
        >>> print(round(float(jaccard_index(torch.tensor([0, 1, 2, 2]), torch.tensor([0, 2, 2, 2]), num_classes=3)), 4))
        0.5556
    """
    confmat = _confusion_matrix_update(preds, target, num_classes, threshold)
    return _jaccard_from_confmat(confmat, num_classes, ignore_index, absent_score, reduction)

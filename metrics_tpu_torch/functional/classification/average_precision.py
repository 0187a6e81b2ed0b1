"""Average precision (counterpart of
``metrics_tpu/functional/classification/average_precision.py``)."""
from typing import List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    _precision_recall_curve_compute,
    _precision_recall_curve_update,
)
from metrics_tpu_torch.obs.warn import warn_once
from metrics_tpu_torch.utils.data import _bincount


def _average_precision_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
) -> Tuple[torch.Tensor, torch.Tensor, int, Optional[int]]:
    preds, target, num_classes, pos_label = _precision_recall_curve_update(preds, target, num_classes, pos_label)
    if average == "micro":
        if preds.ndim == target.ndim:
            preds = preds.reshape(-1)
            target = target.reshape(-1)
            num_classes = 1
        else:
            raise ValueError("Cannot use `micro` average with multi-class input")
    return preds, target, num_classes, pos_label


def _average_precision_compute(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    sample_weights: Optional[Sequence] = None,
) -> Union[List[torch.Tensor], torch.Tensor]:
    precision, recall, _ = _precision_recall_curve_compute(preds, target, num_classes, pos_label)
    if average == "weighted":
        if preds.ndim == target.ndim and target.ndim > 1:
            weights = target.sum(0).to(torch.float32)
        else:
            weights = _bincount(target.to(torch.int64), num_classes).to(torch.float32)
        weights = weights / weights.sum()
    else:
        weights = None
    return _average_precision_compute_with_precision_recall(precision, recall, num_classes, average, weights)


def _average_precision_compute_with_precision_recall(
    precision: Union[torch.Tensor, List[torch.Tensor]],
    recall: Union[torch.Tensor, List[torch.Tensor]],
    num_classes: int,
    average: Optional[str] = "macro",
    weights: Optional[torch.Tensor] = None,
) -> Union[List[torch.Tensor], torch.Tensor]:
    """Step-function integral of the precision-recall curve (recall descending)."""
    if num_classes == 1:
        return -torch.sum((recall[1:] - recall[:-1]) * precision[:-1])

    res = [-torch.sum((r[1:] - r[:-1]) * p[:-1]) for p, r in zip(precision, recall)]

    if average in ("macro", "weighted"):
        res = torch.stack(res)
        nan_mask = torch.isnan(res)
        if bool(nan_mask.any()):
            warn_once(
                "Average precision score for one or more classes was `nan`. Ignoring these classes in average",
                UserWarning,
            )
        if average == "macro":
            return res[~nan_mask].mean()
        weights = torch.ones_like(res) if weights is None else weights
        return (res * weights)[~nan_mask].sum()
    if average is None:
        return res
    allowed_average = ("micro", "macro", "weighted", None)
    raise ValueError(f"Expected argument `average` to be one of {allowed_average} but got {average}")


def average_precision(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    sample_weights: Optional[Sequence] = None,
) -> Union[List[torch.Tensor], torch.Tensor]:
    """Average precision score.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import average_precision
        >>> print(round(float(average_precision(torch.tensor([0.1, 0.8, 0.4, 0.9]), torch.tensor([0, 1, 0, 1]))), 4))
        1.0
    """
    preds, target, num_classes, pos_label = _average_precision_update(preds, target, num_classes, pos_label, average)
    return _average_precision_compute(preds, target, num_classes, pos_label, average, sample_weights)

"""ROC curve at every distinct score (counterpart of
``metrics_tpu/functional/classification/roc.py``); a sort and a cumulative
sum over the buffered samples, like the precision-recall curve."""
from typing import List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    _binary_clf_curve,
    _precision_recall_curve_update,
)
from metrics_tpu_torch.obs.warn import warn_once

Curve = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Curves = Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]


def _roc_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int, Optional[int]]:
    return _precision_recall_curve_update(preds, target, num_classes, pos_label)


def _roc_compute_single_class(
    preds: torch.Tensor,
    target: torch.Tensor,
    pos_label: int,
    sample_weights: Optional[Sequence] = None,
) -> Curve:
    fps, tps, thresholds = _binary_clf_curve(preds, target, sample_weights, pos_label)
    # an extra threshold so the curve starts at (0, 0)
    tps = torch.cat([torch.zeros(1, dtype=tps.dtype, device=tps.device), tps])
    fps = torch.cat([torch.zeros(1, dtype=fps.dtype, device=fps.device), fps])
    thresholds = torch.cat([thresholds[:1] + 1, thresholds])

    if fps[-1] <= 0:
        warn_once(
            "No negative samples in targets, false positive value should be meaningless."
            " Returning zero tensor in false positive score",
            UserWarning,
        )
        fpr = torch.zeros(thresholds.shape, dtype=torch.float32, device=thresholds.device)
    else:
        fpr = fps / fps[-1]

    if tps[-1] <= 0:
        warn_once(
            "No positive samples in targets, true positive value should be meaningless."
            " Returning zero tensor in true positive score",
            UserWarning,
        )
        tpr = torch.zeros(thresholds.shape, dtype=torch.float32, device=thresholds.device)
    else:
        tpr = tps / tps[-1]
    return fpr, tpr, thresholds


def _roc_compute_multi_class(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    sample_weights: Optional[Sequence] = None,
) -> Curves:
    fpr, tpr, thresholds = [], [], []
    for cls in range(num_classes):
        if preds.shape == target.shape:
            target_cls, pos_label = target[:, cls], 1
        else:
            target_cls, pos_label = target, cls
        res = roc(preds[:, cls], target_cls, num_classes=1, pos_label=pos_label, sample_weights=sample_weights)
        fpr.append(res[0])
        tpr.append(res[1])
        thresholds.append(res[2])
    return fpr, tpr, thresholds


def _roc_compute(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Union[Curve, Curves]:
    if num_classes == 1 and preds.ndim == 1:
        if pos_label is None:
            pos_label = 1
        return _roc_compute_single_class(preds, target, pos_label, sample_weights)
    return _roc_compute_multi_class(preds, target, num_classes, sample_weights)


def roc(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Union[Curve, Curves]:
    """False positive rate, true positive rate and thresholds.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import roc
        >>> fpr, tpr, thresholds = roc(torch.tensor([0.1, 0.4, 0.8, 0.9]), torch.tensor([0, 0, 1, 1]))
        >>> print(fpr.tolist(), tpr.tolist())
        [0.0, 0.0, 0.0, 0.5, 1.0] [0.0, 0.5, 1.0, 1.0, 1.0]
    """
    preds, target, num_classes, pos_label = _roc_update(preds, target, num_classes, pos_label)
    return _roc_compute(preds, target, num_classes, pos_label, sample_weights)

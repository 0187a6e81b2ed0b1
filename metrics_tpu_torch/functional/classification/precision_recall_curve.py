"""Precision-recall curve at every distinct score (counterpart of
``metrics_tpu/functional/classification/precision_recall_curve.py``).

The exact curve has as many points as the data has distinct scores, so it
is a sort and a cumulative sum over the buffered samples (plain PyTorch, as
the JAX package computes it outside any kernel). The binned curve is the
constant-memory alternative (``classification/binned_precision_recall.py``).
"""
from typing import List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.obs.warn import warn_once

Curve = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Curves = Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]


def _binary_clf_curve(
    preds: torch.Tensor,
    target: torch.Tensor,
    sample_weights: Optional[Sequence] = None,
    pos_label: int = 1,
) -> Curve:
    """False and true positives, and the threshold, at each distinct score (descending)."""
    if sample_weights is not None and not isinstance(sample_weights, torch.Tensor):
        sample_weights = torch.as_tensor(sample_weights, dtype=torch.float32, device=preds.device)
    if preds.ndim > target.ndim:
        preds = preds[:, 0]
    desc_score_indices = torch.argsort(-preds, stable=True)
    preds = preds[desc_score_indices]
    target = target[desc_score_indices]
    weight = sample_weights[desc_score_indices] if sample_weights is not None else 1.0

    # indices of distinct score values, and the curve's last point
    distinct_value_indices = torch.nonzero(preds[1:] - preds[:-1]).reshape(-1)
    end = torch.full((1,), target.shape[0] - 1, dtype=distinct_value_indices.dtype, device=preds.device)
    threshold_idxs = torch.cat([distinct_value_indices, end])
    target = (target == pos_label).to(torch.int32)
    tps = torch.cumsum(target * weight, dim=0)[threshold_idxs]
    if sample_weights is not None:
        fps = torch.cumsum((1 - target) * weight, dim=0)[threshold_idxs]
    else:
        fps = 1 + threshold_idxs - tps
    return fps, tps, preds[threshold_idxs]


def _precision_recall_curve_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int, Optional[int]]:
    """Flatten the inputs to ``[N]`` (binary) or ``[N, C]`` rows."""
    if preds.ndim == target.ndim:
        if pos_label is None:
            pos_label = 1
        if num_classes is not None and num_classes != 1:
            # multilabel
            if num_classes != preds.shape[1]:
                raise ValueError(
                    f"Argument `num_classes` was set to {num_classes} in"
                    f" metric `precision_recall_curve` but detected {preds.shape[1]}"
                    " number of classes from predictions"
                )
            preds = preds.transpose(0, 1).reshape(num_classes, -1).transpose(0, 1)
            target = target.transpose(0, 1).reshape(num_classes, -1).transpose(0, 1)
        else:
            preds = preds.reshape(-1)
            target = target.reshape(-1)
            num_classes = 1
    elif preds.ndim == target.ndim + 1:
        if pos_label is not None:
            warn_once(
                "Argument `pos_label` should be `None` when running"
                f" multiclass precision recall curve. Got {pos_label}"
            )
        if num_classes != preds.shape[1]:
            raise ValueError(
                f"Argument `num_classes` was set to {num_classes} in"
                f" metric `precision_recall_curve` but detected {preds.shape[1]}"
                " number of classes from predictions"
            )
        preds = preds.transpose(0, 1).reshape(num_classes, -1).transpose(0, 1)
        target = target.reshape(-1)
    else:
        raise ValueError("preds and target must have same number of dimensions, or one additional dimension for preds")
    return preds, target, num_classes, pos_label


def _precision_recall_curve_compute_single_class(
    preds: torch.Tensor,
    target: torch.Tensor,
    pos_label: int,
    sample_weights: Optional[Sequence] = None,
) -> Curve:
    fps, tps, thresholds = _binary_clf_curve(preds, target, sample_weights, pos_label)
    precision = tps / (tps + fps)
    recall = tps / tps[-1]

    # stop when full recall is reached; reverse so recall decreases
    last_ind = int(torch.nonzero(tps == tps[-1])[0, 0])
    sl = slice(0, last_ind + 1)
    precision = torch.cat([precision[sl].flip(0), torch.ones(1, dtype=precision.dtype, device=precision.device)])
    recall = torch.cat([recall[sl].flip(0), torch.zeros(1, dtype=recall.dtype, device=recall.device)])
    return precision, recall, thresholds[sl].flip(0)


def _precision_recall_curve_compute_multi_class(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    sample_weights: Optional[Sequence] = None,
) -> Curves:
    """One binary curve per class."""
    precision, recall, thresholds = [], [], []
    for cls in range(num_classes):
        prc_args = dict(preds=preds[:, cls], target=target, num_classes=1, pos_label=cls, sample_weights=sample_weights)
        if target.ndim > 1:
            prc_args.update(dict(target=target[:, cls], pos_label=1))
        res = precision_recall_curve(**prc_args)
        precision.append(res[0])
        recall.append(res[1])
        thresholds.append(res[2])
    return precision, recall, thresholds


def _precision_recall_curve_compute(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Union[Curve, Curves]:
    if num_classes == 1 and preds.ndim == 1:
        if pos_label is None:
            pos_label = 1
        return _precision_recall_curve_compute_single_class(preds, target, pos_label, sample_weights)
    return _precision_recall_curve_compute_multi_class(preds, target, num_classes, sample_weights)


def precision_recall_curve(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Union[Curve, Curves]:
    """Precision-recall pairs at every distinct threshold.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import precision_recall_curve
        >>> precision, recall, thresholds = precision_recall_curve(torch.tensor([0.1, 0.4, 0.8, 0.9]), torch.tensor([0, 0, 1, 1]))
        >>> print(precision.tolist())
        [1.0, 1.0, 1.0]
    """
    preds, target, num_classes, pos_label = _precision_recall_curve_update(preds, target, num_classes, pos_label)
    return _precision_recall_curve_compute(preds, target, num_classes, pos_label, sample_weights)

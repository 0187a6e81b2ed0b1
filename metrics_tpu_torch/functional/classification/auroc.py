"""Area under the ROC curve (counterpart of
``metrics_tpu/functional/classification/auroc.py``), exact: built on the
ROC curve at every distinct score."""
from typing import Optional, Sequence, Tuple

import torch

from metrics_tpu_torch.functional.classification.auc import _auc_compute_without_check
from metrics_tpu_torch.functional.classification.roc import roc
from metrics_tpu_torch.obs.warn import warn_once
from metrics_tpu_torch.utils.checks import _input_format_classification
from metrics_tpu_torch.utils.data import _bincount
from metrics_tpu_torch.utils.enums import AverageMethod, DataType


def _auroc_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, DataType]:
    """The input case, and multidim inputs flattened to ``[N, C]`` rows."""
    _, _, mode = _input_format_classification(preds, target)
    if mode == DataType.MULTIDIM_MULTICLASS:
        n_classes = preds.shape[1]
        preds = preds.transpose(0, 1).reshape(n_classes, -1).transpose(0, 1)
        target = target.reshape(-1)
    if mode == DataType.MULTILABEL and preds.ndim > 2:
        n_classes = preds.shape[1]
        preds = preds.transpose(0, 1).reshape(n_classes, -1).transpose(0, 1)
        target = target.transpose(0, 1).reshape(n_classes, -1).transpose(0, 1)
    return preds, target, mode


def _auroc_compute(
    preds: torch.Tensor,
    target: torch.Tensor,
    mode: DataType,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    sample_weights: Optional[Sequence] = None,
) -> torch.Tensor:
    if mode == DataType.BINARY:
        num_classes = 1

    if max_fpr is not None:
        if not isinstance(max_fpr, float) or not 0 < max_fpr <= 1:
            raise ValueError(f"`max_fpr` should be a float in range (0, 1], got: {max_fpr}")
        if mode != DataType.BINARY:
            raise ValueError(
                "Partial AUC computation not available in multilabel/multiclass setting,"
                f" 'max_fpr' must be set to `None`, received `{max_fpr}`."
            )

    if mode == DataType.MULTILABEL:
        if average == AverageMethod.MICRO:
            fpr, tpr, _ = roc(preds.reshape(-1), target.reshape(-1), 1, pos_label, sample_weights)
        elif num_classes:
            output = [
                roc(preds[:, i], target[:, i], num_classes=1, pos_label=1, sample_weights=sample_weights)
                for i in range(num_classes)
            ]
            fpr = [o[0] for o in output]
            tpr = [o[1] for o in output]
        else:
            raise ValueError("Detected input to be `multilabel` but you did not provide `num_classes` argument")
    else:
        if mode != DataType.BINARY:
            if num_classes is None:
                raise ValueError("Detected input to `multiclass` but you did not provide `num_classes` argument")
            if average == AverageMethod.WEIGHTED and len(torch.unique(target)) < num_classes:
                # classes with no observation have weight 0: leave them out
                target_bool_mat = torch.zeros((len(target), num_classes), dtype=torch.bool, device=target.device)
                target_bool_mat[torch.arange(len(target), device=target.device), target.long()] = True
                class_observed = target_bool_mat.sum(0) > 0
                for c in range(num_classes):
                    if not bool(class_observed[c]):
                        warn_once(f"Class {c} had 0 observations, omitted from AUROC calculation", UserWarning)
                preds = preds[:, class_observed]
                target = torch.nonzero(target_bool_mat[:, class_observed])[:, 1]
                num_classes = int(class_observed.sum())
                if num_classes == 1:
                    raise ValueError("Found 1 non-empty class in `multiclass` AUROC calculation")
        fpr, tpr, _ = roc(preds, target, num_classes, pos_label, sample_weights)

    if max_fpr is None or max_fpr == 1:
        if mode == DataType.MULTILABEL and average == AverageMethod.MICRO:
            pass
        elif num_classes != 1:
            auc_scores = torch.stack([_auc_compute_without_check(x, y, 1.0) for x, y in zip(fpr, tpr)])
            if average == AverageMethod.NONE:
                return auc_scores
            if average == AverageMethod.MACRO:
                return auc_scores.mean()
            if average == AverageMethod.WEIGHTED:
                if mode == DataType.MULTILABEL:
                    support = target.sum(0)
                else:
                    support = _bincount(target.reshape(-1).to(torch.int64), num_classes)
                return torch.sum(auc_scores * support / support.sum())
            allowed_average = (AverageMethod.NONE.value, AverageMethod.MACRO.value, AverageMethod.WEIGHTED.value)
            raise ValueError(f"Argument `average` expected to be one of the following: {allowed_average} but got {average}")
        return _auc_compute_without_check(fpr, tpr, 1.0)

    max_area = torch.tensor(max_fpr, dtype=torch.float32, device=preds.device)
    # a point at max_fpr, with its tpr interpolated
    stop = int(torch.searchsorted(fpr.to(torch.float32), max_area, right=True))
    weight = (max_area - fpr[stop - 1]) / (fpr[stop] - fpr[stop - 1])
    interp_tpr = tpr[stop - 1] + weight * (tpr[stop] - tpr[stop - 1])
    tpr = torch.cat([tpr[:stop], interp_tpr.reshape(1)])
    fpr = torch.cat([fpr[:stop], max_area.reshape(1)])
    partial_auc = _auc_compute_without_check(fpr, tpr, 1.0)

    # McClish correction
    min_area = 0.5 * max_area**2
    return 0.5 * (1 + (partial_auc - min_area) / (max_area - min_area))


def auroc(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    sample_weights: Optional[Sequence] = None,
) -> torch.Tensor:
    """Exact area under the ROC curve.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import auroc
        >>> print(round(float(auroc(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))), 4))
        0.75
    """
    preds, target, mode = _auroc_update(preds, target)
    return _auroc_compute(preds, target, mode, num_classes, pos_label, average, max_fpr, sample_weights)

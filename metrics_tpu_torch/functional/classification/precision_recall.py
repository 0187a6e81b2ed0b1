"""Precision and recall (counterpart of ``metrics_tpu/functional/classification/precision_recall.py``)."""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.functional.classification.f_beta import _minus_one_where
from metrics_tpu_torch.functional.classification.stat_scores import _reduce_stat_scores, _stat_scores_update
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod


def _precision_recall_validate_args(
    average: Optional[str], mdmc_average: Optional[str], num_classes: Optional[int], ignore_index: Optional[int]
) -> None:
    allowed_average = ("micro", "macro", "weighted", "samples", "none", None)
    if average not in allowed_average:
        raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")
    allowed_mdmc_average = (None, "samplewise", "global")
    if mdmc_average not in allowed_mdmc_average:
        raise ValueError(f"The `mdmc_average` has to be one of {allowed_mdmc_average}, got {mdmc_average}.")
    if average in ("macro", "weighted", "none", None) and (not num_classes or num_classes < 1):
        raise ValueError(f"When you set `average` as {average}, you have to provide the number of classes.")
    if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")


def _mask_absent_classes(
    numerator: torch.Tensor,
    denominator: torch.Tensor,
    tp: torch.Tensor,
    fp: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Marks classes absent from both preds and target with -1, which the reduction skips."""
    if average == AverageMethod.MACRO and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        cond = (tp + fp + fn) == 0
        numerator, denominator = _minus_one_where(cond, numerator), _minus_one_where(cond, denominator)
    if average == AverageMethod.NONE and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        meaningless = (tp | fn | fp) == 0
        numerator, denominator = _minus_one_where(meaningless, numerator), _minus_one_where(meaningless, denominator)
    return numerator, denominator


def _precision_compute(
    tp: torch.Tensor, fp: torch.Tensor, fn: torch.Tensor, average: Optional[str], mdmc_average: Optional[str]
) -> torch.Tensor:
    numerator, denominator = _mask_absent_classes(tp, tp + fp, tp, fp, fn, average, mdmc_average)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else tp + fn,
        average=average,
        mdmc_average=mdmc_average,
    )


def _recall_compute(
    tp: torch.Tensor, fp: torch.Tensor, fn: torch.Tensor, average: Optional[str], mdmc_average: Optional[str]
) -> torch.Tensor:
    numerator, denominator = _mask_absent_classes(tp, tp + fn, tp, fp, fn, average, mdmc_average)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else tp + fn,
        average=average,
        mdmc_average=mdmc_average,
    )


def _counts(
    preds: torch.Tensor,
    target: torch.Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
    ignore_index: Optional[int],
    num_classes: Optional[int],
    threshold: float,
    top_k: Optional[int],
    multiclass: Optional[bool],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    _precision_recall_validate_args(average, mdmc_average, num_classes, ignore_index)
    return _stat_scores_update(
        preds,
        target,
        reduce="macro" if average in ("weighted", "none", None) else average,
        mdmc_reduce=mdmc_average,
        threshold=threshold,
        num_classes=num_classes,
        top_k=top_k,
        multiclass=multiclass,
        ignore_index=ignore_index,
    )


def precision(
    preds: torch.Tensor,
    target: torch.Tensor,
    average: str = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> torch.Tensor:
    """Precision = TP / (TP + FP) of one batch."""
    tp, fp, _, fn = _counts(preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass)
    return _precision_compute(tp, fp, fn, average, mdmc_average)


def recall(
    preds: torch.Tensor,
    target: torch.Tensor,
    average: str = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> torch.Tensor:
    """Recall = TP / (TP + FN) of one batch."""
    tp, fp, _, fn = _counts(preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass)
    return _recall_compute(tp, fp, fn, average, mdmc_average)


def precision_recall(
    preds: torch.Tensor,
    target: torch.Tensor,
    average: str = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precision and recall from one stat-scores pass."""
    tp, fp, _, fn = _counts(preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass)
    return _precision_compute(tp, fp, fn, average, mdmc_average), _recall_compute(tp, fp, fn, average, mdmc_average)

"""Accuracy, including subset accuracy (counterpart of
``metrics_tpu/functional/classification/accuracy.py``)."""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.functional.classification.stat_scores import _reduce_stat_scores, _stat_scores_update
from metrics_tpu_torch.utils.checks import (
    _check_classification_inputs,
    _input_format_classification,
    _input_squeeze,
)
from metrics_tpu_torch.utils.enums import AverageMethod, DataType, MDMCAverageMethod


def _check_subset_validity(mode: DataType) -> bool:
    return mode in (DataType.MULTILABEL, DataType.MULTIDIM_MULTICLASS)


def _mode(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float,
    top_k: Optional[int],
    num_classes: Optional[int],
    multiclass: Optional[bool],
) -> DataType:
    """Input-case inference."""
    return _check_classification_inputs(
        preds, target, threshold=threshold, top_k=top_k, num_classes=num_classes, multiclass=multiclass
    )


def _accuracy_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    reduce: Optional[str],
    mdmc_reduce: Optional[str],
    threshold: float,
    num_classes: Optional[int],
    top_k: Optional[int],
    multiclass: Optional[bool],
    ignore_index: Optional[int],
    mode: DataType,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    if mode == DataType.MULTILABEL and top_k:
        raise ValueError("You can not use the `top_k` parameter to calculate accuracy for multi-label inputs.")
    preds, target = _input_squeeze(preds, target)
    return _stat_scores_update(
        preds,
        target,
        reduce=reduce,
        mdmc_reduce=mdmc_reduce,
        threshold=threshold,
        num_classes=num_classes,
        top_k=top_k,
        multiclass=multiclass,
        ignore_index=ignore_index,
    )


def _accuracy_compute(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
    mode: DataType,
) -> torch.Tensor:
    simple_average = (AverageMethod.MICRO, AverageMethod.SAMPLES)
    if (mode == DataType.BINARY and average in simple_average) or mode == DataType.MULTILABEL:
        numerator = tp + tn
        denominator = tp + tn + fp + fn
    else:
        numerator = tp
        denominator = tp + fn

    if average == AverageMethod.MACRO and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        # absent classes (no tp/fp/fn) are excluded through the -1-ignore convention
        cond = (tp + fp + fn) == 0
        numerator = torch.where(cond, torch.full_like(numerator, -1), numerator)
        denominator = torch.where(cond, torch.full_like(denominator, -1), denominator)

    if average == AverageMethod.NONE and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        # a class is not present if there exists no TPs, no FPs, and no FNs
        meaningless = (tp | fn | fp) == 0
        numerator = torch.where(meaningless, torch.full_like(numerator, -1), numerator)
        denominator = torch.where(meaningless, torch.full_like(denominator, -1), denominator)

    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else tp + fn,
        average=average,
        mdmc_average=mdmc_average,
    )


def _subset_accuracy_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    threshold: float,
    top_k: Optional[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    preds, target = _input_squeeze(preds, target)
    preds, target, mode = _input_format_classification(preds, target, threshold=threshold, top_k=top_k)

    if mode == DataType.MULTILABEL and top_k:
        raise ValueError("You can not use the `top_k` parameter to calculate accuracy for multi-label inputs.")

    device = preds.device
    if mode == DataType.MULTILABEL:
        correct = (preds == target).all(dim=1).sum()
        total = torch.full((), target.shape[0], dtype=torch.int64, device=device)
    elif mode == DataType.MULTICLASS:
        correct = (preds * target).sum(dtype=torch.int64)
        total = target.sum(dtype=torch.int64)
    elif mode == DataType.MULTIDIM_MULTICLASS:
        sample_correct = (preds * target).sum(dim=(1, 2))
        correct = (sample_correct == target.shape[2]).sum()
        total = torch.full((), target.shape[0], dtype=torch.int64, device=device)
    else:
        correct = total = torch.zeros((), dtype=torch.int64, device=device)
    return correct, total


def _subset_accuracy_compute(correct: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    return correct.float() / total


def accuracy(
    preds: torch.Tensor,
    target: torch.Tensor,
    average: str = "micro",
    mdmc_average: Optional[str] = "global",
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    subset_accuracy: bool = False,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> torch.Tensor:
    """Accuracy of one batch over any classification input case."""
    allowed_average = ("micro", "macro", "weighted", "samples", "none", None)
    if average not in allowed_average:
        raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")

    if average in ("macro", "weighted", "none", None) and (not num_classes or num_classes < 1):
        raise ValueError(f"When you set `average` as {average}, you have to provide the number of classes.")

    allowed_mdmc_average = (None, "samplewise", "global")
    if mdmc_average not in allowed_mdmc_average:
        raise ValueError(f"The `mdmc_average` has to be one of {allowed_mdmc_average}, got {mdmc_average}.")

    if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")

    if top_k is not None and (not isinstance(top_k, int) or top_k <= 0):
        raise ValueError(f"The `top_k` should be an integer larger than 0, got {top_k}")

    preds, target = _input_squeeze(preds, target)
    mode = _mode(preds, target, threshold, top_k, num_classes, multiclass)
    reduce = "macro" if average in ("weighted", "none", None) else average

    if subset_accuracy and _check_subset_validity(mode):
        correct, total = _subset_accuracy_update(preds, target, threshold, top_k)
        return _subset_accuracy_compute(correct, total)
    tp, fp, tn, fn = _accuracy_update(
        preds, target, reduce, mdmc_average, threshold, num_classes, top_k, multiclass, ignore_index, mode
    )
    return _accuracy_compute(tp, fp, tn, fn, average, mdmc_average, mode)

"""F-beta and F1 (counterpart of ``metrics_tpu/functional/classification/f_beta.py``)."""
from typing import Optional

import torch

from metrics_tpu_torch.functional.classification.stat_scores import _reduce_stat_scores, _stat_scores_update
from metrics_tpu_torch.ops.safe_ops import safe_divide
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod


def _minus_one_where(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, torch.full_like(x, -1), x)


def _fbeta_compute(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    beta: float,
    ignore_index: Optional[int],
    average: Optional[str],
    mdmc_average: Optional[str],
) -> torch.Tensor:
    if average == AverageMethod.MICRO and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        mask = tp >= 0
        zero = torch.zeros_like(tp)
        tp_sum = torch.where(mask, tp, zero).sum().float()
        precision = safe_divide(tp_sum, torch.where(mask, tp + fp, zero).sum().float())
        recall = safe_divide(tp_sum, torch.where(mask, tp + fn, zero).sum().float())
    else:
        precision = safe_divide(tp.float(), (tp + fp).float())
        recall = safe_divide(tp.float(), (tp + fn).float())

    num = (1 + beta**2) * precision * recall
    denom = beta**2 * precision + recall
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)

    # classes absent from preds and target are meaningless and ignored
    if average == AverageMethod.NONE and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        meaningless = (tp | fn | fp) == 0
        if ignore_index is not None:
            meaningless = meaningless | (torch.arange(meaningless.shape[-1], device=tp.device) == ignore_index)
        num = _minus_one_where(meaningless, num)
        denom = _minus_one_where(meaningless, denom)
    elif ignore_index is not None and average not in (AverageMethod.MICRO, AverageMethod.SAMPLES):
        samplewise = mdmc_average == MDMCAverageMethod.SAMPLEWISE
        idx_mask = torch.arange(num.shape[-1] if samplewise else num.shape[0], device=tp.device) == ignore_index
        if samplewise:
            num = _minus_one_where(idx_mask, num)
            denom = _minus_one_where(idx_mask, denom)
        else:
            shape = [-1] + [1] * (num.ndim - 1)
            num = _minus_one_where(idx_mask.reshape(shape), num)
            denom = _minus_one_where(idx_mask.reshape(shape), denom)

    if average == AverageMethod.MACRO and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        total = tp + fp + fn
        cond = (total == 0) | (total == -3)
        num = _minus_one_where(cond, num)
        denom = _minus_one_where(cond, denom)

    return _reduce_stat_scores(
        numerator=num,
        denominator=denom,
        weights=None if average != AverageMethod.WEIGHTED else tp + fn,
        average=average,
        mdmc_average=mdmc_average,
    )


def fbeta_score(
    preds: torch.Tensor,
    target: torch.Tensor,
    beta: float = 1.0,
    average: str = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> torch.Tensor:
    """F-beta score of one batch."""
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

    reduce = "macro" if average in ("weighted", "none", None) else average
    tp, fp, tn, fn = _stat_scores_update(
        preds,
        target,
        reduce=reduce,
        mdmc_reduce=mdmc_average,
        threshold=threshold,
        num_classes=num_classes,
        top_k=top_k,
        multiclass=multiclass,
        ignore_index=ignore_index,
    )
    return _fbeta_compute(tp, fp, tn, fn, beta, ignore_index, average, mdmc_average)


def f1_score(
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
    """F1 = F-beta with beta = 1."""
    return fbeta_score(
        preds, target, 1.0, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass
    )

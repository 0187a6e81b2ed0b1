"""Stat-scores backbone: tp/fp/tn/fn counting and score reduction
(counterpart of ``metrics_tpu/functional/classification/stat_scores.py``)."""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.ops.safe_ops import safe_divide
from metrics_tpu_torch.utils.checks import _input_format_classification
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod

Counts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _del_column(data: torch.Tensor, idx: int) -> torch.Tensor:
    return torch.cat([data[:, :idx], data[:, idx + 1 :]], dim=1)


def _stat_scores(preds: torch.Tensor, target: torch.Tensor, reduce: Optional[str] = "micro") -> Counts:
    """Count tp/fp/tn/fn of 0/1 ``(N, C)`` or ``(N, C, X)`` inputs over the
    dims ``reduce`` implies: micro ``[]``/``(N,)``, macro ``(C,)``/``(N, C)``,
    samples ``(N,)``/``(N, X)``. All int64."""
    if reduce == "micro":
        dim = (0, 1) if preds.ndim == 2 else (1, 2)
    elif reduce == "macro":
        dim = (0,) if preds.ndim == 2 else (2,)
    else:  # samples
        dim = (1,)

    # For 0/1 inputs the four counts are linear in three sums, one pass each:
    #   tp = sum pt, fp = sum p - tp, fn = sum t - tp, tn = count - sum p - sum t + tp
    # The 0/1 product is exact in the int32 input type; the sums are int64.
    tp = (preds * target).sum(dim=dim, dtype=torch.int64)
    sum_p = preds.sum(dim=dim, dtype=torch.int64)
    sum_t = target.sum(dim=dim, dtype=torch.int64)
    count = 1
    for d in dim:
        count *= preds.shape[d]
    return tp, sum_p - tp, count - sum_p - sum_t + tp, sum_t - tp


def _stat_scores_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    reduce: Optional[str] = "micro",
    mdmc_reduce: Optional[str] = None,
    num_classes: Optional[int] = None,
    top_k: Optional[int] = None,
    threshold: float = 0.5,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Counts:
    """Format inputs and count stat scores."""
    preds, target, _ = _input_format_classification(
        preds, target, threshold=threshold, num_classes=num_classes, multiclass=multiclass, top_k=top_k
    )

    if ignore_index is not None and not 0 <= ignore_index < preds.shape[1]:
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {preds.shape[1]} classes")
    if ignore_index is not None and preds.shape[1] == 1:
        raise ValueError("You can not use `ignore_index` with binary data.")

    if preds.ndim == 3:
        if not mdmc_reduce:
            raise ValueError(
                "When your inputs are multi-dimensional multi-class, you have to set the `mdmc_reduce` parameter"
            )
        if mdmc_reduce == "global":
            preds = preds.transpose(1, 2).reshape(-1, preds.shape[1])
            target = target.transpose(1, 2).reshape(-1, target.shape[1])

    if ignore_index is not None and reduce != "macro":
        preds = _del_column(preds, ignore_index)
        target = _del_column(target, ignore_index)

    tp, fp, tn, fn = _stat_scores(preds, target, reduce=reduce)

    # macro keeps the class axis: mark the ignored class with -1
    if ignore_index is not None and reduce == "macro":
        for t in (tp, fp, tn, fn):
            t[..., ignore_index] = -1

    return tp, fp, tn, fn


def _stat_scores_compute(tp: torch.Tensor, fp: torch.Tensor, tn: torch.Tensor, fn: torch.Tensor) -> torch.Tensor:
    """Stack ``[tp, fp, tn, fn, support]`` along the last dim."""
    outputs = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    return torch.where(outputs < 0, torch.full_like(outputs, -1), outputs)


def _reduce_stat_scores(
    numerator: torch.Tensor,
    denominator: torch.Tensor,
    weights: Optional[torch.Tensor],
    average: Optional[str],
    mdmc_average: Optional[str],
    zero_division: int = 0,
) -> torch.Tensor:
    """Weighted float32 score reduction with zero-division and ``-1``-ignore handling."""
    numerator, denominator = numerator.float(), denominator.float()
    zero_div_mask = denominator == 0
    ignore_mask = denominator < 0

    weights = torch.ones_like(denominator) if weights is None else weights.float()

    numerator = torch.where(zero_div_mask, torch.full_like(numerator, float(zero_division)), numerator)
    denominator = torch.where(ignore_mask, torch.ones_like(denominator), denominator)
    weights = torch.where(ignore_mask, torch.zeros_like(weights), weights)

    if average not in (AverageMethod.MICRO, AverageMethod.NONE, None):
        weights = weights / weights.sum(dim=-1, keepdim=True)

    scores = weights * safe_divide(numerator, denominator)
    # sum(weights) == 0 (e.g. ignoring the only present class with 'weighted')
    scores = torch.where(torch.isnan(scores), torch.full_like(scores, float(zero_division)), scores)

    if mdmc_average == MDMCAverageMethod.SAMPLEWISE:
        scores = scores.mean(dim=0)
        ignore_mask = ignore_mask.sum(dim=0).bool()

    if average in (AverageMethod.NONE, None):
        return torch.where(ignore_mask, torch.full_like(scores, float("nan")), scores)
    return scores.sum()


def stat_scores(
    preds: torch.Tensor,
    target: torch.Tensor,
    reduce: str = "micro",
    mdmc_reduce: Optional[str] = None,
    num_classes: Optional[int] = None,
    top_k: Optional[int] = None,
    threshold: float = 0.5,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> torch.Tensor:
    """``[tp, fp, tn, fn, support]`` of one batch."""
    if reduce not in ["micro", "macro", "samples"]:
        raise ValueError(f"The `reduce` {reduce} is not valid.")
    if mdmc_reduce not in [None, "samplewise", "global"]:
        raise ValueError(f"The `mdmc_reduce` {mdmc_reduce} is not valid.")
    if reduce == "macro" and (not num_classes or num_classes < 1):
        raise ValueError("When you set `reduce` as 'macro', you have to provide the number of classes.")
    if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")

    tp, fp, tn, fn = _stat_scores_update(
        preds,
        target,
        reduce=reduce,
        mdmc_reduce=mdmc_reduce,
        num_classes=num_classes,
        top_k=top_k,
        threshold=threshold,
        multiclass=multiclass,
        ignore_index=ignore_index,
    )
    return _stat_scores_compute(tp, fp, tn, fn)

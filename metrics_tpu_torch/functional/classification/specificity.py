"""Specificity (counterpart of ``metrics_tpu/functional/classification/specificity.py``)."""
from typing import Optional

import torch

from metrics_tpu_torch.functional.classification.f_beta import _minus_one_where
from metrics_tpu_torch.functional.classification.precision_recall import _counts
from metrics_tpu_torch.functional.classification.stat_scores import _reduce_stat_scores
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod


def _specificity_compute(
    tp: torch.Tensor,
    fp: torch.Tensor,
    tn: torch.Tensor,
    fn: torch.Tensor,
    average: Optional[str],
    mdmc_average: Optional[str],
) -> torch.Tensor:
    """TN / (TN + FP); with ``average="none"`` a class absent from preds and target is -1."""
    numerator, denominator = tn, tn + fp
    if average == AverageMethod.NONE and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        meaningless = (tp | fn | fp) == 0
        numerator, denominator = _minus_one_where(meaningless, numerator), _minus_one_where(meaningless, denominator)
    return _reduce_stat_scores(
        numerator=numerator,
        denominator=denominator,
        weights=None if average != AverageMethod.WEIGHTED else tn + fp,
        average=average,
        mdmc_average=mdmc_average,
    )


def specificity(
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
    """Specificity = TN / (TN + FP) of one batch."""
    tp, fp, tn, fn = _counts(preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, multiclass)
    return _specificity_compute(tp, fp, tn, fn, average, mdmc_average)

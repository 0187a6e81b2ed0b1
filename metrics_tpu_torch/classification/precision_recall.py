"""Precision and Recall module metrics (counterpart of ``metrics_tpu/classification/precision_recall.py``)."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.classification.stat_scores import StatScores
from metrics_tpu_torch.functional.classification.precision_recall import _precision_compute, _recall_compute


class _AveragedStatScores(StatScores):
    """StatScores whose ``average`` picks the reduction over classes.

    Args:
        num_classes: number of classes; required by the macro/weighted averages.
        threshold: probability cutoff that binarizes probabilistic/logit inputs.
        average: ``micro``, ``macro``, ``weighted``, ``samples`` or ``none``.
        mdmc_average: ``global`` or ``samplewise`` for multidim-multiclass inputs.
        ignore_index: class label excluded from scoring.
        top_k: score the k highest predictions (the ``select_topk`` kernel for k > 1).
        multiclass: override the automatic binary/multiclass input inference.
        kwargs: see :class:`~metrics_tpu_torch.metric.Metric` (``device``,
            the sync arguments).
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(
        self,
        num_classes: Optional[int] = None,
        threshold: float = 0.5,
        average: str = "micro",
        mdmc_average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        **kwargs: Any,
    ) -> None:
        allowed_average = ["micro", "macro", "weighted", "samples", "none", None]
        if average not in allowed_average:
            raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")
        super().__init__(
            reduce="macro" if average in ["weighted", "none", None] else average,
            mdmc_reduce=mdmc_average,
            threshold=threshold,
            top_k=top_k,
            num_classes=num_classes,
            multiclass=multiclass,
            ignore_index=ignore_index,
            **kwargs,
        )
        self.average = average


class Precision(_AveragedStatScores):
    """Precision = TP / (TP + FP); arguments as :class:`_AveragedStatScores`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Precision
        >>> precision = Precision(num_classes=3, average="macro", device="cpu")
        >>> print(round(float(precision(torch.tensor([0, 2, 1, 0]), torch.tensor([0, 1, 2, 0]))), 4))
        0.3333
    """

    def compute(self) -> torch.Tensor:
        tp, fp, _, fn = self._get_final_stats()
        return _precision_compute(tp, fp, fn, self.average, self.mdmc_reduce)


class Recall(_AveragedStatScores):
    """Recall = TP / (TP + FN); arguments as :class:`_AveragedStatScores`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Recall
        >>> recall = Recall(num_classes=3, average="macro", device="cpu")
        >>> print(round(float(recall(torch.tensor([0, 2, 1, 0]), torch.tensor([0, 1, 2, 0]))), 4))
        0.3333
    """

    def compute(self) -> torch.Tensor:
        tp, fp, _, fn = self._get_final_stats()
        return _recall_compute(tp, fp, fn, self.average, self.mdmc_reduce)

"""FBetaScore and F1Score module metrics (counterpart of ``metrics_tpu/classification/f_beta.py``)."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.classification.stat_scores import StatScores
from metrics_tpu_torch.functional.classification.f_beta import _fbeta_compute


class FBetaScore(StatScores):
    """Weighted harmonic mean of precision and recall.

    Args:
        num_classes: number of classes; required by the macro/weighted averages.
        beta: weight of recall relative to precision.
        threshold: probability cutoff that binarizes probabilistic/logit inputs.
        average: ``micro``, ``macro``, ``weighted``, ``samples`` or ``none``.
        mdmc_average: ``global`` or ``samplewise`` for multidim-multiclass inputs.
        ignore_index: class label excluded from scoring.
        top_k: score the k highest predictions (the ``select_topk`` kernel for k > 1).
        multiclass: override the automatic binary/multiclass input inference.
        device: see :class:`~metrics_tpu_torch.metric.Metric`.
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(
        self,
        num_classes: Optional[int] = None,
        beta: float = 1.0,
        threshold: float = 0.5,
        average: str = "micro",
        mdmc_average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        **kwargs: Any,
    ) -> None:
        self.beta = beta
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

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _fbeta_compute(tp, fp, tn, fn, self.beta, self.ignore_index, self.average, self.mdmc_reduce)


class F1Score(FBetaScore):
    """F1 = FBetaScore with beta = 1."""

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
        super().__init__(
            num_classes=num_classes,
            beta=1.0,
            threshold=threshold,
            average=average,
            mdmc_average=mdmc_average,
            ignore_index=ignore_index,
            top_k=top_k,
            multiclass=multiclass,
            **kwargs,
        )

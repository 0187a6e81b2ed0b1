"""Binned (fixed-threshold) curve metrics (counterpart of
``metrics_tpu/classification/binned_precision_recall.py``).

The state is three ``[C, T]`` counters whatever the number of samples. Each
update counts its batch against every threshold in one launch of the
``binned_counts`` kernel. The computes take every class's average precision
and recall at precision in one pass over the stacked ``[C, T + 1]`` curves.
"""
from typing import Any, List, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops.binned_counts import binned_stat_counts
from metrics_tpu_torch.utils.data import METRIC_EPS, _linspace, to_onehot


def _recall_at_precision(
    precision: torch.Tensor, recall: torch.Tensor, thresholds: torch.Tensor, min_precision: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row of ``[C, T + 1]`` curves, the highest recall with precision >=
    ``min_precision``, and its threshold: the greatest ``(recall, precision,
    threshold)`` triple, in that order, among those that qualify; ``(0, 1e6)``
    when none does. Three masked maxima along dim 1, for every class at once."""
    # precision and recall carry one appended point (1, 0) with no threshold
    n = thresholds.shape[0]
    prec, rec = precision[:, :n], recall[:, :n]
    ok = prec >= min_precision
    rmax = torch.where(ok, rec, float("-inf")).amax(dim=1, keepdim=True)
    tie_r = ok & (rec == rmax)
    pmax = torch.where(tie_r, prec, float("-inf")).amax(dim=1, keepdim=True)
    tie_rp = tie_r & (prec == pmax)
    best_threshold = torch.where(tie_rp, thresholds, float("-inf")).amax(dim=1)

    any_ok = ok.any(dim=1)
    max_recall = torch.where(any_ok, rmax.squeeze(1), 0.0)
    best_threshold = torch.where(any_ok, best_threshold, 0.0)
    best_threshold = torch.where(max_recall == 0.0, 1e6, best_threshold)
    return max_recall, best_threshold


class BinnedPrecisionRecallCurve(Metric):
    """Precision-recall curve over fixed thresholds, in constant memory.

    Args:
        num_classes: number of classes (1 for binary inputs).
        thresholds: an int ``T`` (``T`` evenly spaced thresholds over [0, 1]),
            or a list or tensor of thresholds, used as given (any order).
        device: see :class:`~metrics_tpu_torch.metric.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import BinnedPrecisionRecallCurve
        >>> bprc = BinnedPrecisionRecallCurve(num_classes=1, thresholds=5, device="cpu")
        >>> p, r, t = bprc(torch.tensor([0.1, 0.4, 0.6, 0.9]), torch.tensor([0, 0, 1, 1]))
        >>> print([round(float(v), 2) for v in r])
        [1.0, 1.0, 1.0, 0.5, 0.0, 0.0]
    """

    is_differentiable = False
    higher_is_better = None

    def __init__(
        self,
        num_classes: int,
        thresholds: Union[int, torch.Tensor, List[float], None] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        if isinstance(thresholds, int):
            self.num_thresholds = thresholds
            ths = _linspace(0.0, 1.0, thresholds, device=self.device)
        elif thresholds is not None:
            if not isinstance(thresholds, (list, torch.Tensor)):
                raise ValueError("Expected argument `thresholds` to either be an integer, list of floats or a tensor")
            ths = torch.as_tensor(thresholds, device=self.device)
            self.num_thresholds = ths.numel()
        else:
            raise ValueError("Expected argument `thresholds` to either be an integer, list of floats or a tensor")
        self.register_buffer("thresholds", ths, persistent=False)

        for name in ("TPs", "FPs", "FNs"):
            self.add_state(name, torch.zeros((num_classes, self.num_thresholds), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        if preds.ndim == target.ndim == 1:
            preds = preds.reshape(-1, 1)
            target = target.reshape(-1, 1)
        if preds.ndim == target.ndim + 1:
            target = to_onehot(target, num_classes=self.num_classes).movedim(1, -1).reshape(-1, self.num_classes)
            preds = preds.movedim(1, -1).reshape(-1, self.num_classes)
        tp, fp, fn, _ = binned_stat_counts(preds, (target == 1).to(torch.int32), self.thresholds)
        self.TPs = self.TPs + tp.to(self.TPs.dtype)
        self.FPs = self.FPs + fp.to(self.FPs.dtype)
        self.FNs = self.FNs + fn.to(self.FNs.dtype)

    def _curves(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[C, T + 1]`` precision and recall of every class; the last point
        is precision 1, recall 0, as in ``precision_recall_curve``."""
        precisions = (self.TPs + METRIC_EPS) / (self.TPs + self.FPs + METRIC_EPS)
        recalls = self.TPs / (self.TPs + self.FNs + METRIC_EPS)
        precisions = torch.cat([precisions, torch.ones((self.num_classes, 1), dtype=precisions.dtype, device=precisions.device)], dim=1)
        recalls = torch.cat([recalls, torch.zeros((self.num_classes, 1), dtype=recalls.dtype, device=recalls.device)], dim=1)
        return precisions, recalls

    def compute(self) -> Union[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]]:
        precisions, recalls = self._curves()
        if self.num_classes == 1:
            return precisions[0, :], recalls[0, :], self.thresholds
        return list(precisions), list(recalls), [self.thresholds for _ in range(self.num_classes)]


class BinnedAveragePrecision(BinnedPrecisionRecallCurve):
    """Average precision from the binned curve (per class for ``num_classes > 1``).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import BinnedAveragePrecision
        >>> bap = BinnedAveragePrecision(num_classes=1, thresholds=5, device="cpu")
        >>> print(round(float(bap(torch.tensor([0.1, 0.4, 0.6, 0.9]), torch.tensor([0, 0, 1, 1]))), 4))
        1.0
    """

    def compute(self) -> Union[List[torch.Tensor], torch.Tensor]:  # type: ignore[override]
        # every class's step integral in one [C, T] pass; for C > 1 a list of 0-d tensors
        p, r = self._curves()
        ap = -((r[:, 1:] - r[:, :-1]) * p[:, :-1]).sum(dim=1)
        return ap[0] if self.num_classes == 1 else list(ap)


class BinnedRecallAtFixedPrecision(BinnedPrecisionRecallCurve):
    """The highest recall at a minimum precision, and its threshold.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import BinnedRecallAtFixedPrecision
        >>> brfp = BinnedRecallAtFixedPrecision(num_classes=1, min_precision=0.5, thresholds=5, device="cpu")
        >>> recall, threshold = brfp(torch.tensor([0.1, 0.4, 0.6, 0.9]), torch.tensor([0, 0, 1, 1]))
        >>> print(round(float(recall), 4), round(float(threshold), 4))
        1.0 0.5
    """

    def __init__(
        self,
        num_classes: int,
        min_precision: float,
        thresholds: Union[int, torch.Tensor, Sequence[float], None] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes=num_classes, thresholds=thresholds, **kwargs)
        self.min_precision = min_precision

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:  # type: ignore[override]
        recall, threshold = _recall_at_precision(*self._curves(), self.thresholds, self.min_precision)
        if self.num_classes == 1:
            return recall[0], threshold[0]
        return recall, threshold

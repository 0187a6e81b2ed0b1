"""RetrievalRPrecision (counterpart of ``metrics_tpu/retrieval/r_precision.py``)."""
import torch

from metrics_tpu_torch.functional.retrieval._ranking import GroupedRanking
from metrics_tpu_torch.functional.retrieval.r_precision import _r_precision_grouped
from metrics_tpu_torch.retrieval.base import RetrievalMetric


class RetrievalRPrecision(RetrievalMetric):
    """Mean R-precision over queries.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalRPrecision
        >>> indexes = torch.tensor([0, 0, 0, 1, 1])
        >>> preds = torch.tensor([0.9, 0.3, 0.5, 0.8, 0.2])
        >>> target = torch.tensor([1, 0, 1, 0, 1])
        >>> rprec = RetrievalRPrecision(device="cpu")
        >>> print(round(float(rprec(preds, target, indexes=indexes)), 4))
        0.5
    """

    def _metric_grouped(
        self, preds: torch.Tensor, target: torch.Tensor, indexes: torch.Tensor, g: GroupedRanking
    ) -> torch.Tensor:
        return _r_precision_grouped(g)

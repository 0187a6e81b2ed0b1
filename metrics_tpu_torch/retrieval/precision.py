"""RetrievalPrecision (counterpart of ``metrics_tpu/retrieval/precision.py``)."""
import torch

from metrics_tpu_torch.functional.retrieval._ranking import GroupedRanking
from metrics_tpu_torch.functional.retrieval.precision import _precision_grouped
from metrics_tpu_torch.retrieval._topk_base import _TopKRetrievalMetric


class RetrievalPrecision(_TopKRetrievalMetric):
    """Mean precision at ``k`` over queries.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalPrecision
        >>> indexes = torch.tensor([0, 0, 0, 1, 1])
        >>> preds = torch.tensor([0.9, 0.3, 0.5, 0.8, 0.2])
        >>> target = torch.tensor([1, 0, 1, 0, 1])
        >>> rprec = RetrievalPrecision(k=2, device="cpu")
        >>> print(round(float(rprec(preds, target, indexes=indexes)), 4))
        0.75
    """

    def _metric_grouped(
        self, preds: torch.Tensor, target: torch.Tensor, indexes: torch.Tensor, g: GroupedRanking
    ) -> torch.Tensor:
        return _precision_grouped(g, self.k)

"""RetrievalMAP (counterpart of ``metrics_tpu/retrieval/average_precision.py``)."""
import torch

from metrics_tpu_torch.functional.retrieval._ranking import GroupedRanking
from metrics_tpu_torch.functional.retrieval.average_precision import _average_precision_grouped
from metrics_tpu_torch.retrieval.base import RetrievalMetric


class RetrievalMAP(RetrievalMetric):
    """Mean average precision over queries.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalMAP
        >>> indexes = torch.tensor([0, 0, 0, 1, 1])
        >>> preds = torch.tensor([0.9, 0.3, 0.5, 0.8, 0.2])
        >>> target = torch.tensor([1, 0, 1, 0, 1])
        >>> rmap = RetrievalMAP(device="cpu")
        >>> print(round(float(rmap(preds, target, indexes=indexes)), 4))
        0.75
    """

    def _metric_grouped(
        self, preds: torch.Tensor, target: torch.Tensor, indexes: torch.Tensor, g: GroupedRanking
    ) -> torch.Tensor:
        return _average_precision_grouped(g)

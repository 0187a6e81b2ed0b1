"""RetrievalMRR (counterpart of ``metrics_tpu/retrieval/reciprocal_rank.py``)."""
import torch

from metrics_tpu_torch.functional.retrieval._ranking import GroupedRanking
from metrics_tpu_torch.functional.retrieval.reciprocal_rank import _reciprocal_rank_grouped
from metrics_tpu_torch.retrieval.base import RetrievalMetric


class RetrievalMRR(RetrievalMetric):
    """Mean reciprocal rank over queries.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalMRR
        >>> indexes = torch.tensor([0, 0, 0, 1, 1])
        >>> preds = torch.tensor([0.9, 0.3, 0.5, 0.8, 0.2])
        >>> target = torch.tensor([1, 0, 1, 0, 1])
        >>> mrr = RetrievalMRR(device="cpu")
        >>> print(round(float(mrr(preds, target, indexes=indexes)), 4))
        0.75
    """

    def _metric_grouped(
        self, preds: torch.Tensor, target: torch.Tensor, indexes: torch.Tensor, g: GroupedRanking
    ) -> torch.Tensor:
        return _reciprocal_rank_grouped(g)

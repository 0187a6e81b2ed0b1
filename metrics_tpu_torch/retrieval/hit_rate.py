"""RetrievalHitRate (counterpart of ``metrics_tpu/retrieval/hit_rate.py``)."""
import torch

from metrics_tpu_torch.functional.retrieval._ranking import GroupedRanking
from metrics_tpu_torch.functional.retrieval.hit_rate import _hit_rate_grouped
from metrics_tpu_torch.retrieval._topk_base import _TopKRetrievalMetric


class RetrievalHitRate(_TopKRetrievalMetric):
    """Mean hit rate at ``k`` over queries.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalHitRate
        >>> indexes = torch.tensor([0, 0, 0, 1, 1])
        >>> preds = torch.tensor([0.9, 0.3, 0.5, 0.8, 0.2])
        >>> target = torch.tensor([1, 0, 1, 0, 1])
        >>> hit = RetrievalHitRate(k=2, device="cpu")
        >>> print(round(float(hit(preds, target, indexes=indexes)), 4))
        1.0
    """

    def _metric_grouped(
        self, preds: torch.Tensor, target: torch.Tensor, indexes: torch.Tensor, g: GroupedRanking
    ) -> torch.Tensor:
        return _hit_rate_grouped(g, self.k)

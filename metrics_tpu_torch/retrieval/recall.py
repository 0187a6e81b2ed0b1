"""RetrievalRecall (counterpart of ``metrics_tpu/retrieval/recall.py``)."""
import torch

from metrics_tpu_torch.functional.retrieval._ranking import GroupedRanking
from metrics_tpu_torch.functional.retrieval.recall import _recall_grouped
from metrics_tpu_torch.retrieval._topk_base import _TopKRetrievalMetric


class RetrievalRecall(_TopKRetrievalMetric):
    """Mean recall at ``k`` over queries.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalRecall
        >>> indexes = torch.tensor([0, 0, 0, 1, 1])
        >>> preds = torch.tensor([0.9, 0.3, 0.5, 0.8, 0.2])
        >>> target = torch.tensor([1, 0, 1, 0, 1])
        >>> rec = RetrievalRecall(k=2, device="cpu")
        >>> print(round(float(rec(preds, target, indexes=indexes)), 4))
        1.0
    """

    def _metric_grouped(
        self, preds: torch.Tensor, target: torch.Tensor, indexes: torch.Tensor, g: GroupedRanking
    ) -> torch.Tensor:
        return _recall_grouped(g, self.k)

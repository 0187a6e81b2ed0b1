"""RetrievalNormalizedDCG (counterpart of ``metrics_tpu/retrieval/ndcg.py``)."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.retrieval._ranking import GroupedRanking, _ideal_grouping
from metrics_tpu_torch.functional.retrieval.ndcg import _ndcg_grouped
from metrics_tpu_torch.retrieval._topk_base import _TopKRetrievalMetric


class RetrievalNormalizedDCG(_TopKRetrievalMetric):
    """Mean NDCG at ``k`` over queries; targets may be graded relevance.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalNormalizedDCG
        >>> indexes = torch.tensor([0, 0, 0, 1, 1])
        >>> preds = torch.tensor([0.9, 0.3, 0.5, 0.8, 0.2])
        >>> target = torch.tensor([1, 0, 1, 0, 1])
        >>> ndcg = RetrievalNormalizedDCG(device="cpu")
        >>> print(round(float(ndcg(preds, target, indexes=indexes)), 4))
        0.8155
    """

    def __init__(
        self, empty_target_action: str = "neg", ignore_index: Optional[int] = None, k: Optional[int] = None, **kwargs: Any
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, k=k, **kwargs)
        self.allow_non_binary_target = True

    def _metric_grouped(
        self, preds: torch.Tensor, target: torch.Tensor, indexes: torch.Tensor, g: GroupedRanking
    ) -> torch.Tensor:
        g_ideal = _ideal_grouping(target, indexes, g.num_segments)
        return _ndcg_grouped(g, g_ideal, self.k)

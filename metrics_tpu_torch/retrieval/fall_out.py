"""RetrievalFallOut (counterpart of ``metrics_tpu/retrieval/fall_out.py``)."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.retrieval._ranking import GroupedRanking, _segment_sum
from metrics_tpu_torch.functional.retrieval.fall_out import _fall_out_grouped
from metrics_tpu_torch.retrieval._topk_base import _TopKRetrievalMetric


class RetrievalFallOut(_TopKRetrievalMetric):
    """Mean fall-out at ``k`` over queries; lower is better. A query is empty
    when it has no negative target.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import RetrievalFallOut
        >>> indexes = torch.tensor([0, 0, 0, 1, 1])
        >>> preds = torch.tensor([0.9, 0.3, 0.5, 0.8, 0.2])
        >>> target = torch.tensor([1, 0, 1, 0, 1])
        >>> fallout = RetrievalFallOut(k=2, device="cpu")
        >>> print(round(float(fallout(preds, target, indexes=indexes)), 4))
        0.5
    """

    higher_is_better = False

    def __init__(
        self, empty_target_action: str = "pos", ignore_index: Optional[int] = None, k: Optional[int] = None, **kwargs: Any
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, k=k, **kwargs)

    def _empty_query_mask(self, g: GroupedRanking) -> torch.Tensor:
        return _segment_sum((1 - g.target).to(torch.float32), g) == 0

    def _empty_query_error(self) -> str:
        return "`compute` method was provided with a query with no negative target."

    def _metric_grouped(
        self, preds: torch.Tensor, target: torch.Tensor, indexes: torch.Tensor, g: GroupedRanking
    ) -> torch.Tensor:
        return _fall_out_grouped(g, self.k)

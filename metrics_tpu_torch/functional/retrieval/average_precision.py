"""Retrieval average precision (counterpart of ``metrics_tpu/functional/retrieval/average_precision.py``)."""
import torch

from metrics_tpu_torch.functional.retrieval._ranking import (
    GroupedRanking,
    _segment_sum,
    _sorted_by_scores,
    _within_group_cumsum,
)
from metrics_tpu_torch.ops.safe_ops import safe_divide
from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs


def retrieval_average_precision(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """AP of one query: the mean precision at each relevant document (0 with none).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_average_precision
        >>> print(round(float(retrieval_average_precision(torch.tensor([0.9, 0.3, 0.5]), torch.tensor([1, 0, 1]))), 4))
        1.0
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    st = _sorted_by_scores(preds, target).to(torch.float32)
    hits = torch.cumsum(st, dim=0)
    precision_at = hits / torch.arange(1, st.shape[0] + 1, device=st.device)
    total = st.sum()
    return torch.where(total > 0, safe_divide((precision_at * st).sum(), total), 0.0)


def _average_precision_grouped(g: GroupedRanking) -> torch.Tensor:
    """``[Q]`` AP of every query."""
    t = g.target.to(torch.float32)
    hits = _within_group_cumsum(t, g)
    contrib = t * hits / (g.rank + 1)
    n_pos = _segment_sum(t, g)
    return torch.where(n_pos > 0, safe_divide(_segment_sum(contrib, g), n_pos), 0.0)

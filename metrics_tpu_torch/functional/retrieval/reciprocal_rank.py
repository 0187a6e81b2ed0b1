"""Retrieval reciprocal rank (counterpart of ``metrics_tpu/functional/retrieval/reciprocal_rank.py``)."""
import torch

from metrics_tpu_torch.functional.retrieval._ranking import GroupedRanking, _segment_min, _segment_sum, _sorted_by_scores
from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs


def retrieval_reciprocal_rank(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 / rank of the first relevant document of one query (0 with none).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_reciprocal_rank
        >>> print(round(float(retrieval_reciprocal_rank(torch.tensor([0.9, 0.8, 0.4]), torch.tensor([0, 1, 0]))), 4))
        0.5
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    st = _sorted_by_scores(preds, target)
    first_pos = torch.argmax(st)  # the first maximum: the first hit of binary targets
    return torch.where(st.sum() > 0, 1.0 / (first_pos + 1.0), 0.0)


def _reciprocal_rank_grouped(g: GroupedRanking) -> torch.Tensor:
    t = g.target
    n = t.shape[0]
    # each query's least rank of a hit (n when it has none)
    first = _segment_min(torch.where(t > 0, g.rank, n), g)
    n_pos = _segment_sum(t.to(torch.float32), g)
    return torch.where(n_pos > 0, 1.0 / (first + 1.0), 0.0)

"""Retrieval R-precision, the precision at rank R = the number of relevant
documents (counterpart of ``metrics_tpu/functional/retrieval/r_precision.py``)."""
import torch

from metrics_tpu_torch.functional.retrieval._ranking import GroupedRanking, _segment_sum, _sorted_by_scores
from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs


def retrieval_r_precision(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The share of one query's top R documents that are relevant, R its relevant count.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_r_precision
        >>> print(round(float(retrieval_r_precision(torch.tensor([0.9, 0.8, 0.4]), torch.tensor([1, 0, 1]))), 4))
        0.5
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    st = _sorted_by_scores(preds, target).to(torch.float32)
    n_pos = st.sum()
    relevant = (st * (torch.arange(st.shape[0], device=st.device) < n_pos)).sum()
    return torch.where(n_pos > 0, relevant / n_pos.clamp(min=1.0), 0.0)


def _r_precision_grouped(g: GroupedRanking) -> torch.Tensor:
    t = g.target.to(torch.float32)
    n_pos = _segment_sum(t, g)
    relevant = _segment_sum(t * (g.rank < n_pos[g.seg]), g)
    return torch.where(n_pos > 0, relevant / n_pos.clamp(min=1.0), 0.0)

"""Retrieval recall at k (counterpart of ``metrics_tpu/functional/retrieval/recall.py``)."""
from typing import Optional

import torch

from metrics_tpu_torch.functional.retrieval._ranking import (
    GroupedRanking,
    _k_mask,
    _segment_sum,
    _sorted_by_scores,
    _validate_k,
)
from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs


def retrieval_recall(preds: torch.Tensor, target: torch.Tensor, k: Optional[int] = None) -> torch.Tensor:
    """The share of one query's relevant documents found in its top ``k``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_recall
        >>> print(round(float(retrieval_recall(torch.tensor([0.9, 0.8, 0.4]), torch.tensor([1, 0, 1]), k=2)), 4))
        0.5
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    _validate_k(k)
    n = preds.shape[-1]
    k = n if k is None else k
    st = _sorted_by_scores(preds, target).to(torch.float32)
    relevant = st[: min(k, n)].sum()
    total = st.sum()
    return torch.where(total > 0, relevant / total.clamp(min=1.0), 0.0)


def _recall_grouped(g: GroupedRanking, k: Optional[int] = None) -> torch.Tensor:
    t = g.target.to(torch.float32)
    relevant = _segment_sum(t * _k_mask(g, k), g)
    n_pos = _segment_sum(t, g)
    return torch.where(n_pos > 0, relevant / n_pos.clamp(min=1.0), 0.0)

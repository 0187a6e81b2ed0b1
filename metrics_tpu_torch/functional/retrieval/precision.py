"""Retrieval precision at k (counterpart of ``metrics_tpu/functional/retrieval/precision.py``;
the denominator is the requested ``k``, not ``min(k, n)``)."""
from typing import Optional

import torch

from metrics_tpu_torch.functional.retrieval._ranking import (
    GroupedRanking,
    _k_mask,
    _segment_sum,
    _sorted_by_scores,
    _validate_k,
)
from metrics_tpu_torch.ops.safe_ops import safe_divide
from metrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs


def retrieval_precision(preds: torch.Tensor, target: torch.Tensor, k: Optional[int] = None) -> torch.Tensor:
    """The share of one query's top ``k`` documents that are relevant.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_precision
        >>> print(round(float(retrieval_precision(torch.tensor([0.9, 0.8, 0.4]), torch.tensor([1, 0, 1]), k=2)), 4))
        0.5
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    _validate_k(k)
    n = preds.shape[-1]
    k = n if k is None else k
    st = _sorted_by_scores(preds, target).to(torch.float32)
    relevant = st[: min(k, n)].sum()
    return torch.where(st.sum() > 0, relevant / k, 0.0)


def _precision_grouped(g: GroupedRanking, k: Optional[int] = None) -> torch.Tensor:
    t = g.target.to(torch.float32)
    relevant = _segment_sum(t * _k_mask(g, k), g)
    denom = g.sizes if k is None else torch.full_like(g.sizes, k)
    n_pos = _segment_sum(t, g)
    return torch.where(n_pos > 0, safe_divide(relevant, denom), 0.0)

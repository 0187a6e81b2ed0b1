"""Retrieval hit rate at k (counterpart of ``metrics_tpu/functional/retrieval/hit_rate.py``)."""
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


def retrieval_hit_rate(preds: torch.Tensor, target: torch.Tensor, k: Optional[int] = None) -> torch.Tensor:
    """1 if one query's top ``k`` holds a relevant document, else 0.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_hit_rate
        >>> print(round(float(retrieval_hit_rate(torch.tensor([0.9, 0.8, 0.4]), torch.tensor([0, 1, 0]), k=2)), 4))
        1.0
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    _validate_k(k)
    n = preds.shape[-1]
    k = n if k is None else k
    st = _sorted_by_scores(preds, target).to(torch.float32)
    return (st[: min(k, n)].sum() > 0).to(torch.float32)


def _hit_rate_grouped(g: GroupedRanking, k: Optional[int] = None) -> torch.Tensor:
    t = g.target.to(torch.float32)
    return (_segment_sum(t * _k_mask(g, k), g) > 0).to(torch.float32)

"""Retrieval fall-out at k, the share of the non-relevant documents retrieved
in the top k (counterpart of ``metrics_tpu/functional/retrieval/fall_out.py``)."""
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


def retrieval_fall_out(preds: torch.Tensor, target: torch.Tensor, k: Optional[int] = None) -> torch.Tensor:
    """The share of one query's non-relevant documents that its top ``k`` holds.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_fall_out
        >>> print(round(float(retrieval_fall_out(torch.tensor([0.9, 0.8, 0.4]), torch.tensor([1, 0, 0]), k=2)), 4))
        0.5
    """
    preds, target = _check_retrieval_functional_inputs(preds, target)
    _validate_k(k)
    n = preds.shape[-1]
    k = n if k is None else k
    st = _sorted_by_scores(preds, 1 - target).to(torch.float32)
    irrelevant = st[: min(k, n)].sum()
    total = st.sum()
    return torch.where(total > 0, safe_divide(irrelevant, total), 0.0)


def _fall_out_grouped(g: GroupedRanking, k: Optional[int] = None) -> torch.Tensor:
    neg = (1 - g.target).to(torch.float32)
    irrelevant = _segment_sum(neg * _k_mask(g, k), g)
    n_neg = _segment_sum(neg, g)
    return torch.where(n_neg > 0, safe_divide(irrelevant, n_neg), 0.0)

"""Retrieval normalized discounted cumulative gain (counterpart of
``metrics_tpu/functional/retrieval/ndcg.py``). Targets may be graded."""
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


def _dcg(target: torch.Tensor) -> torch.Tensor:
    denom = torch.log2(torch.arange(target.shape[-1], device=target.device) + 2.0)
    return (target / denom).sum(dim=-1)


def retrieval_normalized_dcg(preds: torch.Tensor, target: torch.Tensor, k: Optional[int] = None) -> torch.Tensor:
    """One query's DCG at ``k`` over the DCG of its ideal ranking.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import retrieval_normalized_dcg
        >>> print(round(float(retrieval_normalized_dcg(torch.tensor([0.9, 0.8, 0.4, 0.2]), torch.tensor([3, 1, 0, 2]))), 4))
        0.9434
    """
    preds, target = _check_retrieval_functional_inputs(preds, target, allow_non_binary_target=True)
    _validate_k(k)
    n = preds.shape[-1]
    k = n if k is None else min(k, n)
    sorted_target = _sorted_by_scores(preds, target)[:k]
    ideal_target = torch.sort(target, descending=True).values[:k]
    ideal_dcg = _dcg(ideal_target)
    return torch.where(ideal_dcg > 0, safe_divide(_dcg(sorted_target), ideal_dcg), 0.0)


def _ndcg_grouped(g: GroupedRanking, g_ideal: GroupedRanking, k: Optional[int] = None) -> torch.Tensor:
    """``[Q]`` NDCG; ``g`` is sorted by predicted score, ``g_ideal`` by target."""
    disc = 1.0 / torch.log2(g.rank + 2.0)
    dcg = _segment_sum(g.target.to(torch.float32) * disc * _k_mask(g, k), g)
    disc_i = 1.0 / torch.log2(g_ideal.rank + 2.0)
    idcg = _segment_sum(g_ideal.target.to(torch.float32) * disc_i * _k_mask(g_ideal, k), g_ideal)
    return torch.where(idcg > 0, safe_divide(dcg, idcg), 0.0)

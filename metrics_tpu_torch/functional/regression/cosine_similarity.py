"""Row-wise cosine similarity (counterpart of
``metrics_tpu/functional/regression/cosine_similarity.py``)."""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape


def _cosine_similarity_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_same_shape(preds, target)
    return preds.to(torch.float32), target.to(torch.float32)


def _cosine_similarity_compute(preds: torch.Tensor, target: torch.Tensor, reduction: Optional[str] = "sum") -> torch.Tensor:
    if reduction not in ("sum", "mean", "none", None):
        raise ValueError(f"Expected argument `reduction` to be one of ('sum', 'mean', 'none', None) but got {reduction}")
    dot_product = (preds * target).sum(dim=-1)
    preds_norm = torch.linalg.vector_norm(preds, dim=-1)
    target_norm = torch.linalg.vector_norm(target, dim=-1)
    similarity = dot_product / (preds_norm * target_norm)
    if reduction == "sum":
        return similarity.sum()
    if reduction == "mean":
        return similarity.mean()
    return similarity


def cosine_similarity(preds: torch.Tensor, target: torch.Tensor, reduction: Optional[str] = "sum") -> torch.Tensor:
    """Row-wise cosine similarity between ``(N, d)`` preds and targets.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import cosine_similarity
        >>> preds = torch.tensor([[3.0, 4.0], [1.0, 0.0]])
        >>> target = torch.tensor([[3.0, 4.0], [0.0, 1.0]])
        >>> print(round(float(cosine_similarity(preds, target, reduction='mean')), 4))
        0.5
    """
    preds, target = _cosine_similarity_update(preds, target)
    return _cosine_similarity_compute(preds, target, reduction)

"""KL divergence (counterpart of ``metrics_tpu/functional/classification/kl_divergence.py``)."""
from typing import Optional, Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import METRIC_EPS


def _kld_update(p: torch.Tensor, q: torch.Tensor, log_prob: bool) -> Tuple[torch.Tensor, int]:
    """Per-row ``D_KL(p || q)`` of two ``[N, D]`` distributions, and ``N``."""
    _check_same_shape(p, q)
    if p.ndim != 2 or q.ndim != 2:
        raise ValueError(f"Expected both p and q distribution to be 2D but got {p.ndim} and {q.ndim} respectively")
    total = p.shape[0]
    if log_prob:
        measures = (p.exp() * (p - q)).sum(dim=-1)
    else:
        p = p / p.sum(dim=-1, keepdim=True)
        q = q / q.sum(dim=-1, keepdim=True)
        q = q.clamp(min=METRIC_EPS)
        measures = (p * (p / q).log()).sum(dim=-1)
    return measures, total


def _kld_compute(
    measures: torch.Tensor, total: Union[int, torch.Tensor], reduction: Optional[str] = "mean"
) -> torch.Tensor:
    if reduction == "sum":
        return measures.sum()
    if reduction == "mean":
        return measures.sum() / total
    if reduction is None or reduction == "none":
        return measures
    return measures / total


def kl_divergence(
    p: torch.Tensor, q: torch.Tensor, log_prob: bool = False, reduction: Optional[str] = "mean"
) -> torch.Tensor:
    """``D_KL(P || Q)`` of one batch: ``mean``, ``sum`` or ``none`` (per row)
    over its rows.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import kl_divergence
        >>> p = torch.tensor([[0.36, 0.48, 0.16]])
        >>> q = torch.tensor([[1 / 3, 1 / 3, 1 / 3]])
        >>> print(round(float(kl_divergence(p, q)), 4))
        0.0853
    """
    measures, total = _kld_update(p, q, log_prob)
    return _kld_compute(measures, total, reduction)

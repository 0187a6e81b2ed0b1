"""Spearman rank correlation (counterpart of
``metrics_tpu/functional/regression/spearman.py``). Ranks come from one sort
and two ``searchsorted`` calls, so tied values share the mean of their
positions in O(n log n)."""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape


def _rank_data(data: torch.Tensor) -> torch.Tensor:
    """Fractional 1-based ranks; ties share the mean of their positions.
    float32 (float64 for float64 data)."""
    s = torch.sort(data).values
    lo = torch.searchsorted(s, data, side="left")
    hi = torch.searchsorted(s, data, side="right")
    # positions lo .. hi-1 (0-based) are the tie block; its mean 1-based rank:
    return (lo + 1 + hi).to(torch.promote_types(data.dtype, torch.float32)) / 2.0


def _spearman_corrcoef_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {preds.dtype} and target: {target.dtype}."
        )
    _check_same_shape(preds, target)
    preds = preds.squeeze()
    target = target.squeeze()
    if preds.ndim > 1 or target.ndim > 1:
        raise ValueError("Expected both predictions and target to be 1 dimensional tensors.")
    return preds, target


def _spearman_corrcoef_compute(preds: torch.Tensor, target: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    preds = _rank_data(preds)
    target = _rank_data(target)
    preds_diff = preds - preds.mean()
    target_diff = target - target.mean()
    cov = (preds_diff * target_diff).mean()
    preds_std = torch.sqrt((preds_diff * preds_diff).mean())
    target_std = torch.sqrt((target_diff * target_diff).mean())
    corrcoef = cov / (preds_std * target_std + eps)
    return corrcoef.clamp(-1.0, 1.0)


def spearman_corrcoef(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Spearman rank correlation between 1-D ``preds`` and ``target``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import spearman_corrcoef
        >>> print(round(float(spearman_corrcoef(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))), 4))
        1.0
    """
    preds, target = _spearman_corrcoef_update(preds, target)
    return _spearman_corrcoef_compute(preds, target)

"""Pearson correlation with streaming (Welford/Chan) statistics (counterpart
of ``metrics_tpu/functional/regression/pearson.py``)."""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape


def _pearson_corrcoef_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    mean_x: torch.Tensor,
    mean_y: torch.Tensor,
    var_x: torch.Tensor,
    var_y: torch.Tensor,
    corr_xy: torch.Tensor,
    n_prior: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Chan step merging a batch into the running first and second moments."""
    _check_same_shape(preds, target)
    preds = preds.squeeze()
    target = target.squeeze()
    if preds.ndim > 1 or target.ndim > 1:
        raise ValueError("Expected both predictions and target to be 1 dimensional tensors.")
    preds = preds if preds.is_floating_point() else preds.float()
    target = target if target.is_floating_point() else target.float()

    n_obs = preds.numel()
    mx_new = (n_prior * mean_x + preds.mean() * n_obs) / (n_prior + n_obs)
    my_new = (n_prior * mean_y + target.mean() * n_obs) / (n_prior + n_obs)
    n_new = n_prior + n_obs
    var_x = var_x + ((preds - mx_new) * (preds - mean_x)).sum()
    var_y = var_y + ((target - my_new) * (target - mean_y)).sum()
    corr_xy = corr_xy + ((preds - mx_new) * (target - mean_y)).sum()
    return mx_new, my_new, var_x, var_y, corr_xy, n_new


def _pearson_corrcoef_compute(
    var_x: torch.Tensor, var_y: torch.Tensor, corr_xy: torch.Tensor, nb: torch.Tensor
) -> torch.Tensor:
    var_x = var_x / (nb - 1)
    var_y = var_y / (nb - 1)
    corr_xy = corr_xy / (nb - 1)
    corrcoef = (corr_xy / torch.sqrt(var_x * var_y)).squeeze()
    return corrcoef.clamp(-1.0, 1.0)


def _final_aggregation(
    means_x: torch.Tensor,
    means_y: torch.Tensor,
    vars_x: torch.Tensor,
    vars_y: torch.Tensor,
    corrs_xy: torch.Tensor,
    nbs: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge stacked per-replica running statistics into global ones, with
    one sum per quantity: each replica's M2 about its own mean plus the
    between-replica term ``n_i * (mean_i - mean)²``."""
    means_x, means_y = torch.atleast_1d(means_x), torch.atleast_1d(means_y)
    vars_x, vars_y = torch.atleast_1d(vars_x), torch.atleast_1d(vars_y)
    corrs_xy, nbs = torch.atleast_1d(corrs_xy), torch.atleast_1d(nbs)

    n = nbs.sum()
    mean_x = (nbs * means_x).sum() / n
    mean_y = (nbs * means_y).sum() / n
    var_x = (vars_x + nbs * (means_x - mean_x) ** 2).sum()
    var_y = (vars_y + nbs * (means_y - mean_y) ** 2).sum()
    corr_xy = (corrs_xy + nbs * (means_x - mean_x) * (means_y - mean_y)).sum()
    return var_x, var_y, corr_xy, n


def pearson_corrcoef(preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Pearson correlation coefficient between 1-D ``preds`` and ``target``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import pearson_corrcoef
        >>> print(round(float(pearson_corrcoef(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))), 4))
        0.9849
    """
    dtype = preds.dtype if preds.is_floating_point() else torch.float32
    zero = torch.zeros(1, dtype=dtype, device=preds.device)
    _, _, var_x, var_y, corr_xy, nb = _pearson_corrcoef_update(preds, target, zero, zero, zero, zero, zero, zero)
    return _pearson_corrcoef_compute(var_x, var_y, corr_xy, nb)

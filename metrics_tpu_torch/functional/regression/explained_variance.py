"""Explained variance (counterpart of
``metrics_tpu/functional/regression/explained_variance.py``)."""
from typing import Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape

_ALLOWED_MULTIOUTPUT = ("raw_values", "uniform_average", "variance_weighted")


def _explained_variance_update(
    preds: torch.Tensor, target: torch.Tensor
) -> Tuple[int, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    _check_same_shape(preds, target)
    diff = target - preds
    return (
        preds.shape[0],
        diff.sum(dim=0),
        (diff * diff).sum(dim=0),
        target.sum(dim=0),
        (target * target).sum(dim=0),
    )


def _explained_variance_compute(
    n_obs: Union[int, torch.Tensor],
    sum_error: torch.Tensor,
    sum_squared_error: torch.Tensor,
    sum_target: torch.Tensor,
    sum_squared_target: torch.Tensor,
    multioutput: str = "uniform_average",
) -> torch.Tensor:
    diff_avg = sum_error / n_obs
    numerator = sum_squared_error / n_obs - diff_avg * diff_avg
    target_avg = sum_target / n_obs
    denominator = sum_squared_target / n_obs - target_avg * target_avg

    nonzero_numerator = numerator != 0
    nonzero_denominator = denominator != 0
    # valid -> 1 - num/den; num != 0 and den == 0 -> 0; num == 0 -> 1 (a perfect fit)
    safe_den = torch.where(nonzero_denominator, denominator, torch.ones_like(denominator))
    output_scores = torch.where(
        nonzero_numerator & nonzero_denominator,
        1.0 - numerator / safe_den,
        torch.where(nonzero_numerator & ~nonzero_denominator, 0.0, 1.0).to(numerator.dtype),
    )

    if multioutput == "raw_values":
        return output_scores
    if multioutput == "uniform_average":
        return output_scores.mean()
    if multioutput == "variance_weighted":
        return (denominator / denominator.sum() * output_scores).sum()
    raise ValueError(f"Argument `multioutput` must be one of {_ALLOWED_MULTIOUTPUT}, got {multioutput}.")


def explained_variance(
    preds: torch.Tensor, target: torch.Tensor, multioutput: str = "uniform_average"
) -> torch.Tensor:
    """Explained variance.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import explained_variance
        >>> print(round(float(explained_variance(torch.tensor([3.0, -0.5, 2.0, 7.0]), torch.tensor([2.5, 0.0, 2.0, 8.0]))), 4))
        0.9645
    """
    if multioutput not in _ALLOWED_MULTIOUTPUT:
        raise ValueError(f"Invalid input to argument `multioutput`. Choose one of the following: {_ALLOWED_MULTIOUTPUT}")
    n_obs, sum_error, sum_squared_error, sum_target, sum_squared_target = _explained_variance_update(preds, target)
    return _explained_variance_compute(n_obs, sum_error, sum_squared_error, sum_target, sum_squared_target, multioutput)

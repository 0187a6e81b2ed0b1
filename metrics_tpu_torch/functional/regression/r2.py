"""R² (coefficient of determination) (counterpart of
``metrics_tpu/functional/regression/r2.py``). The count of observations is
read on the host (one sync), so the adjusted-score fallbacks warn eagerly."""
from typing import Tuple, Union

import torch

from metrics_tpu_torch.obs.warn import warn_once
from metrics_tpu_torch.utils.checks import _check_same_shape

_ALLOWED_MULTIOUTPUT = ("raw_values", "uniform_average", "variance_weighted")


def _r2_score_update(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    _check_same_shape(preds, target)
    if preds.ndim > 2:
        raise ValueError(
            "Expected both prediction and target to be 1D or 2D tensors,"
            f" but received tensors with dimension {tuple(preds.shape)}"
        )
    sum_obs = target.sum(dim=0)
    sum_squared_obs = (target * target).sum(dim=0)
    residual = target - preds
    rss = (residual * residual).sum(dim=0)
    return sum_squared_obs, sum_obs, rss, target.shape[0]


def _r2_score_compute(
    sum_squared_obs: torch.Tensor,
    sum_obs: torch.Tensor,
    rss: torch.Tensor,
    n_obs: Union[int, torch.Tensor],
    adjusted: int = 0,
    multioutput: str = "uniform_average",
) -> torch.Tensor:
    n = int(n_obs)
    if n < 2:
        raise ValueError("Needs at least two samples to calculate r2 score.")

    mean_obs = sum_obs / n_obs
    tss = sum_squared_obs - sum_obs * mean_obs
    raw_scores = 1 - (rss / tss)

    if multioutput == "raw_values":
        r2 = raw_scores
    elif multioutput == "uniform_average":
        r2 = raw_scores.mean()
    elif multioutput == "variance_weighted":
        r2 = (tss / tss.sum() * raw_scores).sum()
    else:
        raise ValueError(
            "Argument `multioutput` must be either `raw_values`,"
            f" `uniform_average` or `variance_weighted`. Received {multioutput}."
        )

    if adjusted < 0 or not isinstance(adjusted, int):
        raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")

    if adjusted != 0:
        if adjusted > n - 1:
            warn_once(
                "More independent regressions than data points in"
                " adjusted r2 score. Falls back to standard r2 score.",
                UserWarning,
            )
        elif adjusted == n - 1:
            warn_once("Division by zero in adjusted r2 score. Falls back to standard r2 score.", UserWarning)
        else:
            r2 = 1 - (1 - r2) * (n - 1) / (n - adjusted - 1)
    return r2


def r2_score(
    preds: torch.Tensor, target: torch.Tensor, adjusted: int = 0, multioutput: str = "uniform_average"
) -> torch.Tensor:
    """R² score; ``adjusted > 0`` gives the adjusted variant.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import r2_score
        >>> print(round(float(r2_score(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))), 4))
        0.9486
    """
    sum_squared_obs, sum_obs, rss, n_obs = _r2_score_update(preds, target)
    return _r2_score_compute(sum_squared_obs, sum_obs, rss, n_obs, adjusted, multioutput)

"""Peak signal-to-noise ratio (counterpart of ``metrics_tpu/functional/image/psnr.py``)."""
import math
from typing import Optional, Tuple, Union

import torch

from metrics_tpu_torch.obs.warn import warn_once
from metrics_tpu_torch.parallel.comm import reduce as _reduce


def _psnr_compute(
    sum_squared_error: torch.Tensor,
    n_obs: torch.Tensor,
    data_range: torch.Tensor,
    base: float = 10.0,
    reduction: str = "elementwise_mean",
) -> torch.Tensor:
    psnr_base_e = 2 * torch.log(data_range) - torch.log(sum_squared_error / n_obs)
    psnr_vals = psnr_base_e * (10 / math.log(base))
    return _reduce(psnr_vals, reduction=reduction)


def _psnr_update(
    preds: torch.Tensor, target: torch.Tensor, dim: Optional[Union[int, Tuple[int, ...]]] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    if dim is None:
        sum_squared_error = torch.sum(torch.square(preds - target))
        return sum_squared_error, torch.full((), target.numel(), dtype=torch.int64, device=target.device)
    diff = preds - target
    dim_list = [dim] if isinstance(dim, int) else list(dim)
    if not dim_list:  # dim=(): no axis reduced, as jnp.sum(axis=()) does
        return diff * diff, torch.full((), target.numel(), dtype=torch.int64, device=target.device)
    sum_squared_error = torch.sum(diff * diff, dim=dim_list)
    n = math.prod(target.shape[d] for d in dim_list)
    return sum_squared_error, torch.full(sum_squared_error.shape, n, dtype=torch.int64, device=target.device)


def peak_signal_noise_ratio(
    preds: torch.Tensor,
    target: torch.Tensor,
    data_range: Optional[float] = None,
    base: float = 10.0,
    reduction: str = "elementwise_mean",
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> torch.Tensor:
    """PSNR = 10 * log10(data_range^2 / MSE).

    Args:
        data_range: the value range of the input; ``target``'s max - min
            when None (only with ``dim=None``).
        base: the logarithm's base.
        reduction: ``elementwise_mean``, ``sum`` or ``none`` over the
            scores of ``dim``.
        dim: the dimensions each score is computed over; None for one score.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import peak_signal_noise_ratio
        >>> target = torch.full((1, 1, 8, 8), 0.5)
        >>> preds = target.clone(); preds[0, 0, 0, 0] = 0.6
        >>> print(round(float(peak_signal_noise_ratio(preds, target, data_range=1.0)), 2))
        38.06
    """
    if dim is None and reduction != "elementwise_mean":
        warn_once(f"The `reduction={reduction}` will not have any effect when `dim` is None.")
    if data_range is None:
        if dim is not None:
            raise ValueError("The `data_range` must be given when `dim` is not None.")
        data_range = target.max() - target.min()
    else:
        # in the inputs' float dtype, as the JAX package's weakly typed scalar computes
        dtype = target.dtype if target.is_floating_point() else torch.float32
        data_range = torch.tensor(float(data_range), dtype=dtype, device=target.device)
    sum_squared_error, n_obs = _psnr_update(preds, target, dim=dim)
    return _psnr_compute(sum_squared_error, n_obs, data_range, base=base, reduction=reduction)

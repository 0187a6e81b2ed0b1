"""Shared pairwise-metric helpers (counterpart of
``metrics_tpu/functional/pairwise/helpers.py``)."""
from typing import Optional, Tuple

import torch


def _check_input(
    x: torch.Tensor, y: Optional[torch.Tensor] = None, zero_diagonal: Optional[bool] = None
) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """Validate shapes and resolve the ``zero_diagonal`` default: True when
    ``y`` is None (``x`` against itself), else False."""
    if x.ndim != 2:
        raise ValueError(f"Expected argument `x` to be a 2D tensor of shape `[N, d]` but got {tuple(x.shape)}")
    if y is not None:
        if y.ndim != 2 or y.shape[1] != x.shape[1]:
            raise ValueError(
                "Expected argument `y` to be a 2D tensor of shape `[M, d]` where"
                " `d` should be same as the last dimension of `x`"
            )
        zero_diagonal = False if zero_diagonal is None else zero_diagonal
    else:
        y = x
        zero_diagonal = True if zero_diagonal is None else zero_diagonal
    return x, y, zero_diagonal


def _zero_diagonal(distance: torch.Tensor, zero_diagonal: bool) -> torch.Tensor:
    """``distance`` with the cells ``i == j``, ``i < min(N, M)``, set to 0 (a copy)."""
    if zero_diagonal:
        distance = distance.clone()
        distance.diagonal().zero_()
    return distance


def _reduce_distance_matrix(distmat: torch.Tensor, reduction: Optional[str] = None) -> torch.Tensor:
    """Reduce a ``[N, M]`` distance matrix along its last dimension."""
    if reduction == "mean":
        return distmat.mean(dim=-1)
    if reduction == "sum":
        return distmat.sum(dim=-1)
    if reduction is None or reduction == "none":
        return distmat
    raise ValueError(f"Expected reduction to be one of `['mean', 'sum', None]` but got {reduction}")


def _promote(x: torch.Tensor, y: torch.Tensor, to_float: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` and ``y`` in one dtype, promoted as ``jnp`` promotes them;
    ``to_float`` turns an integer or bool result into the default float type."""
    dtype = torch.promote_types(x.dtype, y.dtype)
    if to_float and not dtype.is_floating_point:
        dtype = torch.get_default_dtype()
    return x.to(dtype), y.to(dtype)

"""Area under any curve by the trapezoidal rule (counterpart of
``metrics_tpu/functional/classification/auc.py``)."""
from typing import Tuple

import torch


def _auc_update(x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.ndim > 1:
        x = x.squeeze()
    if y.ndim > 1:
        y = y.squeeze()
    if x.ndim > 1 or y.ndim > 1:
        raise ValueError(f"Expected both `x` and `y` tensor to be 1d, but got tensors with dimension {x.ndim} and {y.ndim}")
    if x.numel() != y.numel():
        raise ValueError(f"Expected the same number of elements in `x` and `y` tensor but received {x.numel()} and {y.numel()}")
    return x, y


def _auc_compute_without_check(x: torch.Tensor, y: torch.Tensor, direction: float) -> torch.Tensor:
    """Trapezoidal rule in float32 over a monotone ``x``."""
    return torch.trapezoid(y.to(torch.float32), x.to(torch.float32)) * direction


def _auc_compute(x: torch.Tensor, y: torch.Tensor, reorder: bool = False) -> torch.Tensor:
    """The direction of ``x`` is read from the data (one host sync)."""
    if reorder:
        x_idx = torch.argsort(x, stable=True)
        x = x[x_idx]
        y = y[x_idx]
    dx = x[1:] - x[:-1]
    if bool((dx < 0).any()):
        if bool((dx <= 0).all()):
            direction = -1.0
        else:
            raise ValueError("The `x` tensor is neither increasing or decreasing. Try setting the reorder argument to `True`.")
    else:
        direction = 1.0
    return _auc_compute_without_check(x, y, direction)


def auc(x: torch.Tensor, y: torch.Tensor, reorder: bool = False) -> torch.Tensor:
    """Area under the curve ``y(x)``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import auc
        >>> print(round(float(auc(torch.tensor([0.0, 1.0, 2.0]), torch.tensor([0.0, 1.0, 1.0]))), 4))
        1.5
    """
    x, y = _auc_update(x, y)
    return _auc_compute(x, y, reorder=reorder)

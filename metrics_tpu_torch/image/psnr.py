"""``PeakSignalNoiseRatio`` (counterpart of ``metrics_tpu/image/psnr.py``)."""
from typing import Any, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.image.psnr import _psnr_compute, _psnr_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.obs.warn import warn_once


class PeakSignalNoiseRatio(Metric):
    """Streaming PSNR. With ``dim=None`` the states are two sums; with
    ``dim`` the per-batch scores are buffered (list states).

    Args:
        data_range: the value range of the inputs; the running range of
            ``target`` when None (not with ``dim``).
        base: the logarithm's base.
        reduction: ``elementwise_mean``, ``sum`` or ``none``.
        dim: the dimensions each score is computed over; None for one score.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import PeakSignalNoiseRatio
        >>> target = torch.full((1, 1, 8, 8), 0.5)
        >>> preds = target.clone(); preds[0, 0, 0, 0] = 0.6
        >>> psnr = PeakSignalNoiseRatio(data_range=1.0, device="cpu")
        >>> print(round(float(psnr(preds, target)), 2))
        38.06
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(
        self,
        data_range: Optional[float] = None,
        base: float = 10.0,
        reduction: str = "elementwise_mean",
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if dim is None and reduction != "elementwise_mean":
            warn_once(f"The `reduction={reduction}` will not have any effect when `dim` is None.")
        if dim is None:
            self.add_state("sum_squared_error", default=torch.tensor(0.0), dist_reduce_fx="sum")
            self.add_state("total", default=torch.tensor(0), dist_reduce_fx="sum")
        else:
            self.add_state("sum_squared_error", default=[], dist_reduce_fx="cat")
            self.add_state("total", default=[], dist_reduce_fx="cat")
        if data_range is None:
            if dim is not None:
                raise ValueError("The `data_range` must be given when `dim` is not None.")
            self.data_range = None
            self.add_state("min_target", default=torch.tensor(float("inf")), dist_reduce_fx="min")
            self.add_state("max_target", default=torch.tensor(float("-inf")), dist_reduce_fx="max")
        else:
            self.add_state("data_range", default=torch.tensor(float(data_range)), dist_reduce_fx="mean")
        self.base = base
        self.reduction = reduction
        self.dim = tuple(dim) if isinstance(dim, Sequence) else dim

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        sum_squared_error, n_obs = _psnr_update(preds, target, dim=self.dim)
        if self.dim is None:
            if self.data_range is None:
                self.min_target = torch.minimum(target.min(), self.min_target)
                self.max_target = torch.maximum(target.max(), self.max_target)
            self.sum_squared_error = self.sum_squared_error + sum_squared_error
            self.total = self.total + n_obs
        else:
            self.sum_squared_error.append(sum_squared_error)
            self.total.append(n_obs)

    def compute(self) -> torch.Tensor:
        data_range = self.data_range if self.data_range is not None else self.max_target - self.min_target
        if self.dim is None:
            sum_squared_error, total = self.sum_squared_error, self.total
        else:
            sum_squared_error = torch.cat([v.reshape(-1) for v in self.sum_squared_error])
            total = torch.cat([v.reshape(-1) for v in self.total])
        return _psnr_compute(sum_squared_error, total, data_range, base=self.base, reduction=self.reduction)

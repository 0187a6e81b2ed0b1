"""``StructuralSimilarityIndexMeasure`` and
``MultiScaleStructuralSimilarityIndexMeasure`` (counterpart of
``metrics_tpu/image/ssim.py``). Both buffer ``preds`` and ``target`` in list
states, so a ``data_range`` read from the data spans the whole stream, and
compute over the whole buffer at once, as the JAX package does."""
from typing import Any, Optional, Sequence, Tuple

import torch

from metrics_tpu_torch.functional.image.ssim import _multiscale_ssim_compute, _ssim_check_inputs, _ssim_compute
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.obs.warn import warn_once
from metrics_tpu_torch.utils.data import dim_zero_cat


class StructuralSimilarityIndexMeasure(Metric):
    """SSIM over the whole stream of ``[N, C, H, W]`` batches.

    Args:
        kernel_size: the gaussian window's size on each spatial axis.
        sigma: the gaussian's standard deviation on each spatial axis.
        reduction: ``elementwise_mean``, ``sum`` or ``none``.
        data_range: the value range of the inputs; read from the data when None.
        k1, k2: the stability constants of the SSIM formula.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import StructuralSimilarityIndexMeasure
        >>> target = torch.full((1, 1, 8, 8), 0.5)
        >>> preds = target.clone(); preds[0, 0, 0, 0] = 0.6
        >>> ssim = StructuralSimilarityIndexMeasure(data_range=1.0, device="cpu")
        >>> print(round(float(ssim(preds, target)), 4))
        0.9523
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(
        self,
        kernel_size: Sequence[int] = (11, 11),
        sigma: Sequence[float] = (1.5, 1.5),
        reduction: str = "elementwise_mean",
        data_range: Optional[float] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        warn_once(
            "Metric `SSIM` will save all targets and predictions in buffer."
            " For large datasets this may lead to large memory footprint."
        )
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.reduction = reduction

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target = _ssim_check_inputs(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> torch.Tensor:
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _ssim_compute(preds, target, self.kernel_size, self.sigma, self.reduction, self.data_range, self.k1, self.k2)


class MultiScaleStructuralSimilarityIndexMeasure(Metric):
    """MS-SSIM over the whole stream, buffered as SSIM is.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MultiScaleStructuralSimilarityIndexMeasure
        >>> ms_ssim = MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, device="cpu")
        >>> imgs = torch.rand((1, 1, 176, 176), generator=torch.Generator().manual_seed(0))
        >>> print(round(float(ms_ssim(imgs, imgs)), 4))  # identical images -> 1
        1.0
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(
        self,
        kernel_size: Sequence[int] = (11, 11),
        sigma: Sequence[float] = (1.5, 1.5),
        reduction: str = "elementwise_mean",
        data_range: Optional[float] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
        normalize: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        warn_once(
            "Metric `MS_SSIM` will save all targets and predictions in buffer."
            " For large datasets this may lead to large memory footprint."
        )
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")
        if not (isinstance(kernel_size, Sequence) and all(isinstance(ks, int) for ks in kernel_size)):
            raise ValueError(f"Argument `kernel_size` expected to be an sequence of int. Got {kernel_size}")
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.reduction = reduction
        if not isinstance(betas, tuple) or not all(isinstance(beta, float) for beta in betas):
            raise ValueError("Argument `betas` is expected to be of a type tuple of floats.")
        self.betas = betas
        if normalize is not None and normalize not in ("relu", "simple"):
            raise ValueError("Argument `normalize` to be expected either `None` or one of 'relu' or 'simple'")
        self.normalize = normalize

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target = _ssim_check_inputs(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> torch.Tensor:
        preds = dim_zero_cat(self.preds)
        target = dim_zero_cat(self.target)
        return _multiscale_ssim_compute(
            preds,
            target,
            self.kernel_size,
            self.sigma,
            self.reduction,
            self.data_range,
            self.k1,
            self.k2,
            self.betas,
            self.normalize,
        )

"""Kernel Inception Distance (counterpart of ``metrics_tpu/image/kid.py``).

The polynomial-kernel MMD over random feature subsets. The subsets are the
JAX package's: ``np.random.default_rng(seed)`` draws every real permutation
first, then every fake one. They are evaluated one at a time, as the JAX
package's ``lax.map`` does, so the peak memory is one subset's kernel
matrices; the kernels run with TF32 off. The std over subsets has ddof 0.
"""
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.image.fid import _extract, _resolve_feature_extractor
from metrics_tpu_torch.image.networks._common import full_fp32
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat


def maximum_mean_discrepancy(k_xx: torch.Tensor, k_xy: torch.Tensor, k_yy: torch.Tensor) -> torch.Tensor:
    """Unbiased MMD^2 estimate from kernel matrices (reference ``kid.py:30-48``)."""
    m = k_xx.shape[-1]
    diag_x = torch.diagonal(k_xx, dim1=-2, dim2=-1)
    diag_y = torch.diagonal(k_yy, dim1=-2, dim2=-1)
    kt_xx_sum = k_xx.sum(dim=(-2, -1)) - diag_x.sum(dim=-1)
    kt_yy_sum = k_yy.sum(dim=(-2, -1)) - diag_y.sum(dim=-1)
    k_xy_sum = k_xy.sum(dim=(-2, -1))
    value = (kt_xx_sum + kt_yy_sum) / (m * (m - 1))
    return value - 2 * k_xy_sum / (m**2)


def poly_kernel(
    f1: torch.Tensor, f2: torch.Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0
) -> torch.Tensor:
    """Polynomial kernel (reference ``kid.py:51-56``), matmul TF32 off."""
    if gamma is None:
        gamma = 1.0 / f1.shape[-1]
    with full_fp32():
        return (f1 @ f2.transpose(-2, -1) * gamma + coef) ** degree


def poly_mmd(
    f_real: torch.Tensor, f_fake: torch.Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0
) -> torch.Tensor:
    """MMD with the polynomial kernel (reference ``kid.py:59-66``)."""
    k_11 = poly_kernel(f_real, f_real, degree, gamma, coef)
    k_22 = poly_kernel(f_fake, f_fake, degree, gamma, coef)
    k_12 = poly_kernel(f_real, f_fake, degree, gamma, coef)
    return maximum_mean_discrepancy(k_11, k_12, k_22)


class KernelInceptionDistance(Metric):
    """KID: mean/std of polynomial MMD over random feature subsets.

    Args:
        feature: callable ``imgs -> [N, d]``, or an int selecting the default
            InceptionV3 tap (built from ``weights_path``, see FID).
        subsets / subset_size: resampling configuration.
        degree / gamma / coef: polynomial kernel parameters.
        seed: host RNG seed for subset sampling.
        weights_path: local InceptionV3 ``.npz`` weights for the int default.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import KernelInceptionDistance
        >>> def extractor(imgs):  # any callable imgs -> [N, d]
        ...     return imgs.float().reshape(imgs.shape[0], -1)[:, :8]
        >>> kid = KernelInceptionDistance(feature=extractor, subset_size=16, device="cpu")
        >>> gen = torch.Generator().manual_seed(0)
        >>> kid.update(torch.rand(32, 3, 8, 8, generator=gen), real=True)
        >>> kid.update(torch.rand(32, 3, 8, 8, generator=gen), real=False)
        >>> kid_mean, kid_std = kid.compute()  # near zero: same distribution
        >>> print(abs(float(kid_mean)) < 0.1)
        True
    """

    is_differentiable = False
    higher_is_better = False

    def __init__(
        self,
        feature: Union[int, Callable] = 2048,
        subsets: int = 100,
        subset_size: int = 1000,
        degree: int = 3,
        gamma: Optional[float] = None,
        coef: float = 1.0,
        seed: int = 42,
        weights_path: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("jit_update", False)  # extractor call is user code
        kwargs.setdefault("compute_on_step", False)  # reference ``kid.py:219``
        super().__init__(**kwargs)
        if isinstance(feature, int):
            feature = _resolve_feature_extractor(feature, weights_path, self.device)
        if not callable(feature):
            raise TypeError("Got unknown input to argument `feature`")
        self.inception = feature
        if not (isinstance(subsets, int) and subsets > 0):
            raise ValueError("Argument `subsets` expected to be integer larger than 0")
        self.subsets = subsets
        if not (isinstance(subset_size, int) and subset_size > 0):
            raise ValueError("Argument `subset_size` expected to be integer larger than 0")
        self.subset_size = subset_size
        if not (isinstance(degree, int) and degree > 0):
            raise ValueError("Argument `degree` expected to be integer larger than 0")
        self.degree = degree
        if gamma is not None and not (isinstance(gamma, float) and gamma > 0):
            raise ValueError("Argument `gamma` expected to be `None` or float larger than 0")
        self.gamma = gamma
        if not (isinstance(coef, float) and coef > 0):
            raise ValueError("Argument `coef` expected to be float larger than 0")
        self.coef = coef
        self._seed = seed
        self.add_state("real_features", default=[], dist_reduce_fx="cat")
        self.add_state("fake_features", default=[], dist_reduce_fx="cat")

    def update(self, imgs: Any, real: bool = True) -> None:
        features = _extract(self.inception, imgs, self.device)
        if real:
            self.real_features.append(features)
        else:
            self.fake_features.append(features)

    def subset_indices(self, n_real: int, n_fake: int) -> Tuple[np.ndarray, np.ndarray]:
        """``[subsets, subset_size]`` row indices of the real and fake
        features: the JAX package's draws (every real permutation first)."""
        rng = np.random.default_rng(self._seed)
        real_idx = np.stack([rng.permutation(n_real)[: self.subset_size] for _ in range(self.subsets)])
        fake_idx = np.stack([rng.permutation(n_fake)[: self.subset_size] for _ in range(self.subsets)])
        return real_idx, fake_idx

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:
        real_features = dim_zero_cat(self.real_features)
        out_dtype = real_features.dtype
        real_features = real_features.to(torch.float64)
        fake_features = dim_zero_cat(self.fake_features).to(torch.float64)
        n_real, n_fake = real_features.shape[0], fake_features.shape[0]
        if n_real < self.subset_size or n_fake < self.subset_size:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")
        real_idx, fake_idx = (torch.from_numpy(i).to(real_features.device) for i in self.subset_indices(n_real, n_fake))
        kid_scores = torch.stack(
            [
                poly_mmd(real_features[real_idx[s]], fake_features[fake_idx[s]], self.degree, self.gamma, self.coef)
                for s in range(self.subsets)
            ]
        )
        return kid_scores.mean().to(out_dtype), kid_scores.std(correction=0).to(out_dtype)

"""SSIM and MS-SSIM (counterpart of ``metrics_tpu/functional/image/ssim.py``).

The five local moments (of ``preds``, ``target``, their squares and their
product) are one depthwise convolution with a gaussian window over the
5-way stack of the reflect-padded inputs, as in the JAX package. On the
card that convolution runs with TF32 off (a scoped
``torch.backends.cudnn.flags``): TF32 would cost about 1e-3 of SSIM. The
multi-scale pyramid is 2 x 2 average pooling; MS-SSIM combines the scales
per image before any batch reduction, as the JAX package does.
"""
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from metrics_tpu_torch.parallel.comm import reduce as _reduce
from metrics_tpu_torch.utils.checks import _check_same_shape


def _gaussian(kernel_size: int, sigma: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """1-D gaussian window, ``(1, kernel_size)``, summing to one."""
    dist = torch.arange((1 - kernel_size) / 2, (1 + kernel_size) / 2, 1.0, dtype=dtype, device=device)
    gauss = torch.exp(-torch.square(dist / sigma) / 2)
    return (gauss / gauss.sum())[None, :]


def _gaussian_kernel(
    channel: int, kernel_size: Sequence[int], sigma: Sequence[float], dtype: torch.dtype, device: torch.device
) -> torch.Tensor:
    """Depthwise 2-D gaussian kernel, ``(C, 1, kh, kw)``: the outer product of two windows."""
    kernel_x = _gaussian(kernel_size[0], sigma[0], dtype, device)
    kernel_y = _gaussian(kernel_size[1], sigma[1], dtype, device)
    kernel = kernel_x.T * kernel_y
    return kernel.expand(channel, 1, kernel_size[0], kernel_size[1]).contiguous()


def _depthwise_conv2d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Per-channel valid convolution, NCHW by ``(C, 1, kh, kw)``, in full
    float32 precision (TF32 off for this call only)."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic, allow_tf32=False):
        return F.conv2d(x, kernel, groups=x.shape[1])


def _local_moments(preds: torch.Tensor, target: torch.Tensor, kernel: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """``[5N, C, H, W]``: the gaussian-weighted local means of preds, target,
    preds², target² and preds·target (the padded stack is freed on return)."""
    preds = F.pad(preds, (pad_w, pad_w, pad_h, pad_h), mode="reflect")
    target = F.pad(target, (pad_w, pad_w, pad_h, pad_h), mode="reflect")
    stack = torch.cat((preds, target, preds * preds, target * target, preds * target))
    del preds, target
    return _depthwise_conv2d(stack, kernel)


def _ssim_check_inputs(preds: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {preds.dtype} and target: {target.dtype}."
        )
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    return preds, target


def _ssim_compute(
    preds: torch.Tensor,
    target: torch.Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: str = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_contrast_sensitivity: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The SSIM map, reduced; with ``return_contrast_sensitivity``, each
    image's mean SSIM and mean contrast sensitivity."""
    if len(kernel_size) != 2 or len(sigma) != 2:
        raise ValueError(
            "Expected `kernel_size` and `sigma` to have the length of two."
            f" Got kernel_size: {len(kernel_size)} and sigma: {len(sigma)}."
        )
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")

    if data_range is None:  # a device scalar: no host sync
        data_range = torch.maximum(preds.max() - preds.min(), target.max() - target.min())
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    dtype = preds.dtype if preds.is_floating_point() else torch.float32
    preds, target = preds.to(dtype), target.to(dtype)
    kernel = _gaussian_kernel(preds.shape[1], kernel_size, sigma, dtype, preds.device)
    outputs = _local_moments(preds, target, kernel, (kernel_size[0] - 1) // 2, (kernel_size[1] - 1) // 2)
    mu_pred, mu_target, e_pred_sq, e_target_sq, e_pred_target = outputs.chunk(5)

    mu_pred_sq = mu_pred**2
    mu_target_sq = mu_target**2
    mu_pred_target = mu_pred * mu_target
    sigma_pred_sq = e_pred_sq - mu_pred_sq
    sigma_target_sq = e_target_sq - mu_target_sq
    sigma_pred_target = e_pred_target - mu_pred_target
    del outputs, mu_pred, mu_target, e_pred_sq, e_target_sq, e_pred_target

    upper = 2 * sigma_pred_target + c2
    lower = sigma_pred_sq + sigma_target_sq + c2
    ssim_idx = ((2 * mu_pred_target + c1) * upper) / ((mu_pred_sq + mu_target_sq + c1) * lower)

    if return_contrast_sensitivity:
        return ssim_idx.mean(dim=(1, 2, 3)), (upper / lower).mean(dim=(1, 2, 3))
    return _reduce(ssim_idx, reduction)


def structural_similarity_index_measure(
    preds: torch.Tensor,
    target: torch.Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: str = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """SSIM over ``[N, C, H, W]`` images.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import structural_similarity_index_measure
        >>> target = torch.full((1, 1, 8, 8), 0.5)
        >>> preds = target.clone(); preds[0, 0, 0, 0] = 0.6
        >>> print(round(float(structural_similarity_index_measure(preds, target, data_range=1.0)), 4))
        0.9523
    """
    preds, target = _ssim_check_inputs(preds, target)
    return _ssim_compute(preds, target, kernel_size, sigma, reduction, data_range, k1, k2)


def _avg_pool2d(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, (2, 2))


def _multiscale_ssim_compute(
    preds: torch.Tensor,
    target: torch.Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: str = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = None,
) -> torch.Tensor:
    """MS-SSIM: each image's contrast sensitivities at the coarser scales
    times its similarity at the last, then the batch reduction."""
    if preds.shape[-1] < 2 ** len(betas) or preds.shape[-2] < 2 ** len(betas):
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)}, the image height and width dimensions must be"
            f" larger than or equal to {2 ** len(betas)}."
        )
    _betas_div = max(1, (len(betas) - 1)) ** 2
    if preds.shape[-2] // _betas_div <= kernel_size[0] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {kernel_size[0]},"
            f" the image height must be larger than {(kernel_size[0] - 1) * _betas_div}."
        )
    if preds.shape[-1] // _betas_div <= kernel_size[1] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {kernel_size[1]},"
            f" the image width must be larger than {(kernel_size[1] - 1) * _betas_div}."
        )

    sim_list: List[torch.Tensor] = []
    cs_list: List[torch.Tensor] = []
    for _ in range(len(betas)):
        sim, cs = _ssim_compute(
            preds, target, kernel_size, sigma, reduction, data_range, k1, k2, return_contrast_sensitivity=True
        )
        if normalize == "relu":
            sim, cs = torch.relu(sim), torch.relu(cs)
        sim_list.append(sim)
        cs_list.append(cs)
        preds, target = _avg_pool2d(preds), _avg_pool2d(target)

    sim_stack = torch.stack(sim_list)  # [scales, N]
    cs_stack = torch.stack(cs_list)
    if normalize == "simple":
        sim_stack = (sim_stack + 1) / 2
        cs_stack = (cs_stack + 1) / 2
    betas_t = torch.tensor(betas, dtype=sim_stack.dtype, device=sim_stack.device)[:, None]
    sim_stack = sim_stack**betas_t
    cs_stack = cs_stack**betas_t
    per_image = torch.prod(cs_stack[:-1], dim=0) * sim_stack[-1]  # [N]
    return _reduce(per_image, reduction)


def multiscale_structural_similarity_index_measure(
    preds: torch.Tensor,
    target: torch.Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: str = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = None,
) -> torch.Tensor:
    """MS-SSIM over ``[N, C, H, W]`` images.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import multiscale_structural_similarity_index_measure
        >>> preds = torch.rand((1, 1, 256, 256), generator=torch.Generator().manual_seed(0))
        >>> print(round(float(multiscale_structural_similarity_index_measure(preds, preds * 0.9 + 0.05, data_range=1.0)), 2))
        1.0
    """
    if not isinstance(betas, tuple) or not all(isinstance(beta, float) for beta in betas):
        raise ValueError("Argument `betas` is expected to be of a type tuple of floats.")
    if normalize is not None and normalize not in ("relu", "simple"):
        raise ValueError("Argument `normalize` to be expected either `None` or one of 'relu' or 'simple'")
    preds, target = _ssim_check_inputs(preds, target)
    return _multiscale_ssim_compute(preds, target, kernel_size, sigma, reduction, data_range, k1, k2, betas, normalize)

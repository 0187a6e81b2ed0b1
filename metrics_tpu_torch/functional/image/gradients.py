"""Image gradients (counterpart of ``metrics_tpu/functional/image/gradients.py``)."""
from typing import Tuple

import torch
import torch.nn.functional as F


def _compute_image_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Finite differences dy, dx, zero-padded on the last row and column."""
    dy = img[..., 1:, :] - img[..., :-1, :]
    dx = img[..., :, 1:] - img[..., :, :-1]
    return F.pad(dy, (0, 0, 0, 1)), F.pad(dx, (0, 1, 0, 0))


def image_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients ``(dy, dx)`` of an ``(N, C, H, W)`` image batch.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import image_gradients
        >>> img = torch.arange(16, dtype=torch.float32).reshape(1, 1, 4, 4)
        >>> dy, dx = image_gradients(img)
        >>> print(float(dy[0, 0, 0, 0]), float(dx[0, 0, 0, 0]))
        4.0 1.0
    """
    if not isinstance(img, torch.Tensor):
        raise TypeError(f"The `img` expects a value of <Tensor> type but got {type(img)}")
    if img.ndim != 4:
        raise RuntimeError("The `img` expects a 4D tensor")
    return _compute_image_gradients(img)

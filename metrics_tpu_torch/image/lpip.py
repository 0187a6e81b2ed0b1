"""Learned Perceptual Image Patch Similarity (counterpart of
``metrics_tpu/image/lpip.py``): the streaming mean of a perceptual distance,
in ``sum_scores``/``total`` states. The network is pluggable: any callable
``(img1, img2) -> [N]`` distances, or ``'alex'``/``'vgg'`` built from local
weights on the metric's device (``image/networks/lpips.py``); it follows the
metric to its device.
"""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.metric import Metric


class LearnedPerceptualImagePatchSimilarity(Metric):
    """Streaming mean LPIPS distance.

    Args:
        net: callable ``(img1, img2) -> [N]`` perceptual distances, or one of
            the reference net names (``"alex"``/``"vgg"`` built from
            ``weights_path``; ``"squeeze"`` is not implemented).
        normalize: if True inputs are expected in ``[0, 1]`` and are shifted
            to the net's ``[-1, 1]`` convention before the forward.
        weights_path: local ``.npz`` weights for the named nets (see
            ``convert_torch_lpips_checkpoint``); falls back to
            ``$METRICS_TPU_LPIPS_WEIGHTS``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import LearnedPerceptualImagePatchSimilarity
        >>> dist_net = lambda a, b: ((a - b) ** 2).mean(dim=(1, 2, 3))  # custom distance
        >>> lpips = LearnedPerceptualImagePatchSimilarity(net=dist_net, device="cpu")
        >>> imgs = torch.rand(4, 3, 16, 16, generator=torch.Generator().manual_seed(0))
        >>> print(round(float(lpips(imgs, imgs)), 4))  # identical images -> 0
        0.0
    """

    is_differentiable = True
    higher_is_better = False

    def __init__(
        self,
        net: Union[str, Callable] = "alex",
        normalize: bool = False,
        weights_path: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("jit_update", False)  # net call is user code
        super().__init__(**kwargs)
        if isinstance(net, str):
            if net not in ("alex", "vgg", "squeeze"):
                raise ValueError(f"Argument `net` must be one of 'alex', 'vgg', 'squeeze' or a callable, got {net}")
            if net == "squeeze":
                raise ModuleNotFoundError(
                    "The 'squeeze' LPIPS backbone is not implemented natively yet; use 'alex',"
                    " 'vgg', or pass `net=<callable (img1, img2) -> [N] distances>`."
                )
            from metrics_tpu_torch.image.networks.lpips import resolve_lpips_network

            net = resolve_lpips_network(net, weights_path, device=self.device)
        if not callable(net):
            raise TypeError("Got unknown input to argument `net`")
        self.net = net
        if not isinstance(normalize, bool):
            raise ValueError(f"Argument `normalize` should be a bool but got {normalize}")
        self.normalize = normalize
        self.add_state("sum_scores", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, img1: torch.Tensor, img2: torch.Tensor) -> None:
        if self.normalize:  # [0, 1] -> [-1, 1]
            img1 = 2 * img1 - 1
            img2 = 2 * img2 - 1
        net = self.net.on(self.device) if hasattr(self.net, "on") else self.net
        loss = torch.as_tensor(net(img1, img2)).to(self.device).squeeze()
        self.sum_scores = self.sum_scores + loss.sum()
        self.total = self.total + torch.atleast_1d(loss).shape[0]

    def compute(self) -> torch.Tensor:
        return self.sum_scores / self.total

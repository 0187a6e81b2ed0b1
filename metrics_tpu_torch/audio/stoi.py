"""``ShortTimeObjectiveIntelligibility`` (counterpart of ``metrics_tpu/audio/stoi.py``):
native STOI/ESTOI on the metric's device, no ``pystoi``."""
from typing import Any

import torch

from metrics_tpu_torch.functional.audio.stoi import short_time_objective_intelligibility
from metrics_tpu_torch.metric import Metric


class ShortTimeObjectiveIntelligibility(Metric):
    """Streaming mean STOI/ESTOI over batches of (preds, target) signals.
    The update is eager unless ``jit_update=True`` is given, as in the JAX
    package; with it the update is captured like any other.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import ShortTimeObjectiveIntelligibility
        >>> g = torch.Generator().manual_seed(3)
        >>> target = torch.randn(20000, generator=g)
        >>> noise = torch.randn(20000, generator=g)
        >>> stoi = ShortTimeObjectiveIntelligibility(fs=10000, device="cpu")
        >>> print(float(stoi(target + 0.3 * noise, target)) > 0.8)
        True
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(self, fs: int, extended: bool = False, **kwargs: Any) -> None:
        kwargs.setdefault("jit_update", False)
        super().__init__(**kwargs)
        self.fs = fs
        self.extended = extended
        self.add_state("sum_stoi", default=0.0, dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        stoi_batch = short_time_objective_intelligibility(preds, target, self.fs, self.extended)
        self.sum_stoi = self.sum_stoi + stoi_batch.sum()
        self.total = self.total + stoi_batch.numel()

    def compute(self) -> torch.Tensor:
        return self.sum_stoi / self.total

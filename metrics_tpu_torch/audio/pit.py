"""``PermutationInvariantTraining`` (counterpart of ``metrics_tpu/audio/pit.py``)."""
import inspect
from typing import Any, Callable, Dict

import torch

from metrics_tpu_torch.functional.audio.pit import permutation_invariant_training
from metrics_tpu_torch.metric import Metric

#: the keyword arguments that go to ``Metric.__init__``; the rest go to ``metric_func``
_METRIC_KWARGS = tuple(p for p in inspect.signature(Metric.__init__).parameters if p != "self")


class PermutationInvariantTraining(Metric):
    """Streaming mean of the best-permutation metric value.

    Args:
        metric_func: batch-mapped metric on torch tensors,
            ``metric_func(preds[:, i], target[:, j]) -> [batch]``.
        eval_func: ``"max"`` or ``"min"``.
        kwargs: :class:`~metrics_tpu_torch.metric.Metric`'s arguments
            (``device`` among them); the others are passed to
            ``metric_func`` on every update.

    Past six speakers the assignment runs on the host (scipy), so the
    update falls back to the eager one (``compile_stats()["jit_failed"]``).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import PermutationInvariantTraining
        >>> from metrics_tpu_torch.functional.audio import scale_invariant_signal_noise_ratio
        >>> target = torch.randn(1, 2, 64, generator=torch.Generator().manual_seed(0))
        >>> preds = target.flip(1)  # speakers swapped
        >>> pit = PermutationInvariantTraining(scale_invariant_signal_noise_ratio, eval_func='max', device="cpu")
        >>> print(float(pit(preds, target)) > 40)  # perfect after permutation
        True
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(
        self,
        metric_func: Callable,
        eval_func: str = "max",
        **kwargs: Dict[str, Any],
    ) -> None:
        base_kwargs = {k: kwargs.pop(k) for k in _METRIC_KWARGS if k in kwargs}
        super().__init__(**base_kwargs)
        self.metric_func = metric_func
        self.eval_func = eval_func
        self.kwargs = kwargs
        self.add_state("sum_pit_metric", default=0.0, dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        pit_metric = permutation_invariant_training(preds, target, self.metric_func, self.eval_func, **self.kwargs)[0]
        self.sum_pit_metric = self.sum_pit_metric + pit_metric.sum()
        self.total = self.total + pit_metric.numel()

    def compute(self) -> torch.Tensor:
        return self.sum_pit_metric / self.total

"""Unroll a per-class result into one keyed scalar per class (counterpart
of ``metrics_tpu/wrappers/classwise.py``). The wrapper holds one inner
metric and no state of its own."""
from typing import Any, Dict, List, Optional

import torch

from metrics_tpu_torch.metric import Metric

__all__ = ["ClasswiseWrapper"]


class ClasswiseWrapper(Metric):
    """Wrap a metric whose ``compute`` returns a per-class vector (e.g.
    ``Recall(num_classes=C, average=None)``); ``compute`` and ``forward``
    return ``{f"{classname.lower()}_{label}": scalar}``, with labels
    ``0..C-1`` unless ``labels`` names them.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Recall
        >>> from metrics_tpu_torch.wrappers import ClasswiseWrapper
        >>> cw = ClasswiseWrapper(Recall(num_classes=3, average=None, device="cpu"))
        >>> cw.update(torch.tensor([0, 1, 2, 0]), torch.tensor([0, 1, 1, 0]))
        >>> print(sorted(cw.compute().keys()))
        ['recall_0', 'recall_1', 'recall_2']
    """

    full_state_update = True

    def __init__(self, metric: Metric, labels: Optional[List[str]] = None, **kwargs: Any) -> None:
        if not isinstance(metric, Metric):
            raise ValueError(f"Expected argument `metric` to be an instance of `metrics_tpu_torch.Metric` but got {metric}")
        if labels is not None and not (isinstance(labels, list) and all(isinstance(lab, str) for lab in labels)):
            raise ValueError(f"Expected argument `labels` to be either `None` or a list of strings but got {labels}")
        kwargs.setdefault("jit_update", False)  # update mutates the child metric
        kwargs.setdefault("device", metric.device)
        super().__init__(**kwargs)
        self.metric = metric
        self.labels = labels

    def _convert(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        name = self.metric.__class__.__name__.lower()
        if self.labels is None:
            return {f"{name}_{i}": val for i, val in enumerate(x)}
        return {f"{name}_{lab}": val for lab, val in zip(self.labels, x)}

    def update(self, *args: Any, **kwargs: Any) -> None:
        self.metric.update(*args, **kwargs)

    def compute(self) -> Dict[str, torch.Tensor]:
        return self._convert(self.metric.compute())

    def forward(self, *args: Any, **kwargs: Any) -> Optional[Dict[str, torch.Tensor]]:
        batch_val = self.metric(*args, **kwargs)
        self._update_count += 1
        self._computed = None
        if batch_val is None or not self.compute_on_step:
            return None
        self._forward_cache = self._convert(batch_val)
        return self._forward_cache

    def reset(self) -> None:
        super().reset()
        self.metric.reset()

    def _children(self) -> Dict[str, Metric]:
        return {"base": self.metric}

"""Track the running min and max of a wrapped metric's value (counterpart
of ``metrics_tpu/wrappers/minmax.py``).

The trackers are plain tensors on the metric's device, not registered
states: they follow computed values, so a sync and unsync leaves them as
they are; ``clone``, pickling and ``to_device`` carry them.
"""
from typing import Any, Callable, Dict, Union

import torch

from metrics_tpu_torch.metric import Metric

__all__ = ["MinMaxMetric"]


class MinMaxMetric(Metric):
    """Return ``{"raw", "max", "min"}`` of the wrapped metric at each compute.

    The wrapper lives on its base metric's device unless ``device`` is given.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanMetric, MinMaxMetric
        >>> mm = MinMaxMetric(MeanMetric(device="cpu"))
        >>> mm.update(torch.tensor([1.0]))
        >>> _ = mm.compute()
        >>> mm.update(torch.tensor([3.0]))
        >>> print({k: round(float(v), 2) for k, v in mm.compute().items()})
        {'raw': 2.0, 'max': 2.0, 'min': 1.0}
    """

    full_state_update = True

    def __init__(self, base_metric: Metric, **kwargs: Any) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of `metrics_tpu_torch.Metric` but received {base_metric}"
            )
        kwargs.setdefault("jit_update", False)  # update mutates the child metric
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)
        self._base_metric = base_metric
        self.min_val = torch.tensor(float("inf"), device=self.device)
        self.max_val = torch.tensor(float("-inf"), device=self.device)

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._base_metric.update(*args, **kwargs)

    def _fold(self, val: Any) -> Dict[str, torch.Tensor]:
        if not self._is_suitable_val(val):
            raise RuntimeError(
                f"Returned value from base metric should be a scalar (int, float or tensor of size 1, but got {val}"
            )
        val = torch.as_tensor(val, device=self.device)
        self.max_val = torch.maximum(self.max_val, val)
        self.min_val = torch.minimum(self.min_val, val)
        return {"raw": val, "max": self.max_val, "min": self.min_val}

    def compute(self) -> Dict[str, torch.Tensor]:
        """The wrapped metric's value, folded into the trackers."""
        return self._fold(self._base_metric.compute())

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """The base metric's batch value, folded into the trackers."""
        batch_val = self._base_metric(*args, **kwargs)
        self._update_count += 1
        self._computed = None
        if batch_val is None or not self.compute_on_step:
            return None
        self._forward_cache = self._fold(batch_val)
        return self._forward_cache

    def reset(self) -> None:
        """Reset the trackers to their bounds and the base metric."""
        super().reset()
        self.min_val = torch.tensor(float("inf"), device=self.device)
        self.max_val = torch.tensor(float("-inf"), device=self.device)
        self._base_metric.reset()

    def _children(self) -> Dict[str, Metric]:
        return {"base": self._base_metric}

    def _apply(self, fn: Callable, *args: Any, **kwargs: Any) -> "MinMaxMetric":
        super()._apply(fn, *args, **kwargs)
        self.min_val, self.max_val = fn(self.min_val), fn(self.max_val)
        return self

    @staticmethod
    def _is_suitable_val(val: Union[int, float, torch.Tensor]) -> bool:
        if isinstance(val, (int, float)):
            return True
        if isinstance(val, torch.Tensor):
            return val.numel() == 1
        return False

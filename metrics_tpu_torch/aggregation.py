"""Streaming aggregation metrics with a NaN policy (counterpart of
``metrics_tpu/aggregation.py``).

``nan_strategy`` decides, in the eager update, what a NaN in the input
does; ±inf is data, as in the JAX package:

* ``"error"``: raise a ``RuntimeError``; the state is left as it was.
* ``"warn"``: drop the NaN elements, with a warning.
* ``"ignore"``: drop the NaN elements silently.
* ``"disable"``: no check; a NaN propagates into the state.
* a float: replace each NaN by it.

Inputs of rank 2 and more are flattened when NaNs are dropped. ``MeanMetric``
drops a (value, weight) pair when either is NaN, and fills both.
"""
from typing import Any, Callable, List, Tuple, Union

import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops.safe_ops import kahan_add
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.prints import rank_zero_warn

_NAN_STRATEGIES = ("error", "warn", "ignore", "disable")


class BaseAggregator(Metric):
    """Base of the aggregation metrics: one ``value`` state reduced by ``fn``.

    Args:
        fn: the state's ``dist_reduce_fx``.
        default_value: the state's default.
        nan_strategy: ``"error"``, ``"warn"``, ``"ignore"``, ``"disable"`` or a float.
        kwargs: see :class:`~metrics_tpu_torch.metric.Metric`.
    """

    is_differentiable = None
    higher_is_better = None

    def __init__(
        self,
        fn: Union[Callable, str],
        default_value: Union[torch.Tensor, List],
        nan_strategy: Union[str, float] = "error",
        **kwargs: Any,
    ) -> None:
        if nan_strategy not in _NAN_STRATEGIES and not isinstance(nan_strategy, (float, int)):
            raise ValueError(
                f"Arg `nan_strategy` should either be a float or one of {_NAN_STRATEGIES} but got {nan_strategy}."
            )
        super().__init__(**kwargs)
        self.nan_strategy = nan_strategy
        self.add_state("value", default=default_value, dist_reduce_fx=fn)

    def _as_float(self, x: Union[float, torch.Tensor]) -> torch.Tensor:
        x = torch.as_tensor(x, device=self._device)
        return x if x.is_floating_point() else x.float()

    def _screen(self, value: torch.Tensor, *paired: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Apply ``nan_strategy`` to ``value`` and the tensors paired with it
        (of its shape): raise, drop the elements where any is NaN, or fill."""
        tensors = (value, *paired)
        if isinstance(self.nan_strategy, (float, int)) and not isinstance(self.nan_strategy, bool):
            return tuple(torch.where(torch.isnan(t), torch.full_like(t, float(self.nan_strategy)), t) for t in tensors)
        if self.nan_strategy == "disable":
            return tensors
        nans = torch.isnan(tensors[0])
        for t in tensors[1:]:
            nans = nans | torch.isnan(t)
        if not bool(nans.any()):
            return tensors
        if self.nan_strategy == "error":
            raise RuntimeError("Encountered `nan` values in tensor")
        if self.nan_strategy == "warn":
            rank_zero_warn("Encountered `nan` values in tensor. Will be removed.", UserWarning)
        return tuple(t[~nans] for t in tensors)

    def update(self, value: Union[float, torch.Tensor]) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def compute(self) -> torch.Tensor:
        return self.value


class MaxMetric(BaseAggregator):
    """Running maximum.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MaxMetric
        >>> metric = MaxMetric(device="cpu")
        >>> metric.update(torch.tensor([1.0, 5.0, 2.0]))
        >>> print(float(metric.compute()))
        5.0
    """

    full_state_update = True

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("max", torch.tensor(-float("inf")), nan_strategy, **kwargs)

    def update(self, value: Union[float, torch.Tensor]) -> None:
        (value,) = self._screen(self._as_float(value))
        if value.numel():
            self.value = torch.maximum(self.value, value.max())


class MinMetric(BaseAggregator):
    """Running minimum.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MinMetric
        >>> metric = MinMetric(device="cpu")
        >>> metric.update(torch.tensor([3.0, 1.0, 2.0]))
        >>> print(float(metric.compute()))
        1.0
    """

    full_state_update = True

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("min", torch.tensor(float("inf")), nan_strategy, **kwargs)

    def update(self, value: Union[float, torch.Tensor]) -> None:
        (value,) = self._screen(self._as_float(value))
        if value.numel():
            self.value = torch.minimum(self.value, value.min())


class SumMetric(BaseAggregator):
    """Running sum.

    Args:
        compensated: Kahan (compensated) summation of the running total,
            with one more state (``value_comp``).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SumMetric
        >>> metric = SumMetric(device="cpu")
        >>> metric.update(torch.tensor([1.0, 2.0, 3.0]))
        >>> print(float(metric.compute()))
        6.0
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", compensated: bool = False, **kwargs: Any) -> None:
        super().__init__("sum", torch.tensor(0.0), nan_strategy, **kwargs)
        self.compensated = compensated
        if compensated:
            self.add_state("value_comp", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, value: Union[float, torch.Tensor]) -> None:
        (value,) = self._screen(self._as_float(value))
        if not value.numel():
            return
        if self.compensated:
            self.value, self.value_comp = kahan_add(self.value, self.value_comp, value.sum())
        else:
            self.value = self.value + value.sum()


class CatMetric(BaseAggregator):
    """All values seen, concatenated along dim 0.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CatMetric
        >>> metric = CatMetric(device="cpu")
        >>> metric.update(torch.tensor([1.0, 2.0]))
        >>> metric.update(torch.tensor(3.0))
        >>> print(metric.compute().tolist())
        [1.0, 2.0, 3.0]
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("cat", [], nan_strategy, **kwargs)

    def update(self, value: Union[float, torch.Tensor]) -> None:
        (value,) = self._screen(self._as_float(value))
        if value.numel():
            self.value.append(value)

    def compute(self) -> torch.Tensor:
        if isinstance(self.value, list) and self.value:
            return dim_zero_cat(self.value)
        return self.value


class MeanMetric(BaseAggregator):
    """Weighted running mean.

    Args:
        compensated: Kahan-compensate both running sums (value and weight).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanMetric
        >>> metric = MeanMetric(device="cpu")
        >>> metric.update(torch.tensor([1.0, 2.0, 3.0]))
        >>> print(float(metric.compute()))
        2.0
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", compensated: bool = False, **kwargs: Any) -> None:
        super().__init__("sum", torch.tensor(0.0), nan_strategy, **kwargs)
        self.add_state("weight", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.compensated = compensated
        if compensated:
            self.add_state("value_comp", default=torch.tensor(0.0), dist_reduce_fx="sum")
            self.add_state("weight_comp", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def update(self, value: Union[float, torch.Tensor], weight: Union[float, torch.Tensor] = 1.0) -> None:
        value = self._as_float(value)
        weight = torch.as_tensor(weight, dtype=value.dtype, device=value.device).broadcast_to(value.shape)
        value, weight = self._screen(value, weight)
        if not value.numel():
            return
        if self.compensated:
            self.value, self.value_comp = kahan_add(self.value, self.value_comp, (value * weight).sum())
            self.weight, self.weight_comp = kahan_add(self.weight, self.weight_comp, weight.sum())
        else:
            self.value = self.value + (value * weight).sum()
            self.weight = self.weight + weight.sum()

    def compute(self) -> torch.Tensor:
        return self.value / self.weight

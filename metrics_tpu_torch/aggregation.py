"""Streaming aggregation metrics with a NaN policy (counterpart of
``metrics_tpu/aggregation.py``).

``nan_strategy`` is an alias over the screening layer
(``resilience/health.py``), as in the JAX package; it screens NaN only
(``health_screen="nan"``): ±inf is data.

* ``"ignore"`` and ``"warn"`` map to ``on_bad_input="mask"``: the NaN
  elements are dropped inside the update program (rank >= 2 values are
  flattened first by ``_health_prescreen``, so whole elements go, as a
  boolean filter would drop them). ``"warn"`` warns at every removal, which
  only an eager update can do, so a ``"warn"`` instance runs eagerly.
* ``"error"`` maps to ``on_bad_input="raise"``: the update is quarantined and
  a :class:`~metrics_tpu_torch.utils.exceptions.NumericalHealthError` (a
  ``RuntimeError``) raised.
* a float fills each NaN with it (``torch.where``, no screening).
* ``"disable"`` maps to ``"propagate"``: no NaN handling.

``MaxMetric`` and ``MinMetric`` take ``"ignore"`` as a fill with the
reduction's identity (∓inf), which equals removal. ``CatMetric`` keeps its
host-side element filter (a list buffer runs eagerly anyway). ``MeanMetric``
drops or fills a (value, weight) pair when either is NaN. Passing
``on_bad_input`` yourself opts out of the alias.
"""
from typing import Any, Callable, List, Tuple, Union

import torch

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops.safe_ops import kahan_add
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.prints import rank_zero_warn

_NAN_STRATEGIES = ("error", "warn", "ignore", "disable")
_LEGACY_TO_POLICY = {"error": "raise", "warn": "mask", "ignore": "mask", "disable": "propagate"}


def _as_float(x: Any, device: torch.device) -> torch.Tensor:
    """A float tensor of ``x``; a Python number becomes a fill on ``device``
    (no host-to-device copy, which a graph capture refuses)."""
    if isinstance(x, torch.Tensor):
        return x if x.is_floating_point() else x.float()
    if isinstance(x, (int, float)):
        return torch.full((), float(x), dtype=torch.float32, device=device)
    x = torch.as_tensor(x, device=device)
    return x if x.is_floating_point() else x.float()


def _flatten_value_prescreen(args: Any, kwargs: Any) -> Tuple[Any, Any]:
    """Screening prescreen of the flatten-invariant aggregators: rank >= 2
    values are flattened, so masking drops elements."""

    def _flat(x: Any) -> Any:
        return x.reshape(-1) if isinstance(x, torch.Tensor) and x.ndim >= 2 else x

    return tuple(_flat(a) for a in args), {k: _flat(v) for k, v in kwargs.items()}


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
        legacy_mapped = "on_bad_input" not in kwargs
        if legacy_mapped:
            kwargs["on_bad_input"] = _LEGACY_TO_POLICY[nan_strategy] if isinstance(nan_strategy, str) else "propagate"
        super().__init__(**kwargs)
        self.health_screen = "nan"
        self._health_warn_on_bad = legacy_mapped and nan_strategy == "warn"
        self.nan_strategy = nan_strategy
        self.add_state("value", default=default_value, dist_reduce_fx=fn)

    def _fill(self, x: torch.Tensor) -> torch.Tensor:
        """Apply a float ``nan_strategy`` (the other strategies are the
        screening layer's)."""
        if isinstance(self.nan_strategy, (float, int)) and not isinstance(self.nan_strategy, bool):
            return torch.where(torch.isnan(x), torch.full_like(x, float(self.nan_strategy)), x)
        return x

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
        if "on_bad_input" not in kwargs and nan_strategy == "ignore":
            kwargs["on_bad_input"] = "propagate"  # removal is a fill with -inf
        super().__init__("max", torch.tensor(-float("inf")), nan_strategy, **kwargs)

    def _health_prescreen(self, args: Any, kwargs: Any) -> Any:
        return _flatten_value_prescreen(args, kwargs)

    def update(self, value: Union[float, torch.Tensor]) -> None:
        value = self._fill(_as_float(value, self._device))
        if self.nan_strategy in ("warn", "ignore"):
            value = torch.where(torch.isnan(value), torch.full_like(value, -float("inf")), value)
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
        if "on_bad_input" not in kwargs and nan_strategy == "ignore":
            kwargs["on_bad_input"] = "propagate"  # removal is a fill with +inf
        super().__init__("min", torch.tensor(float("inf")), nan_strategy, **kwargs)

    def _health_prescreen(self, args: Any, kwargs: Any) -> Any:
        return _flatten_value_prescreen(args, kwargs)

    def update(self, value: Union[float, torch.Tensor]) -> None:
        value = self._fill(_as_float(value, self._device))
        if self.nan_strategy in ("warn", "ignore"):
            value = torch.where(torch.isnan(value), torch.full_like(value, float("inf")), value)
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

    # per-element sums: eligible for `jit_bucket` and the compiled "mask",
    # except under the Kahan carry (order-dependent)
    @property
    def _batch_additive(self) -> bool:
        return not getattr(self, "compensated", False)

    def _health_prescreen(self, args: Any, kwargs: Any) -> Any:
        return _flatten_value_prescreen(args, kwargs)

    def update(self, value: Union[float, torch.Tensor]) -> None:
        value = self._fill(_as_float(value, self._device))
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
        # a list buffer updates eagerly, so the host-side element filter below
        # is the right one; row masking would drop whole rows of 2-D values
        if "on_bad_input" not in kwargs and nan_strategy in ("warn", "ignore"):
            kwargs["on_bad_input"] = "propagate"
        super().__init__("cat", [], nan_strategy, **kwargs)

    def update(self, value: Union[float, torch.Tensor]) -> None:
        value = self._fill(_as_float(value, self._device))
        if self.nan_strategy in ("warn", "ignore"):
            nans = torch.isnan(value)
            if bool(nans.any()):
                if self.nan_strategy == "warn":
                    rank_zero_warn("Encountered `nan` values in tensor. Will be removed.", UserWarning)
                value = value[~nans]
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

    # value and weight sums are per element (the Kahan carry excepted)
    @property
    def _batch_additive(self) -> bool:
        return not getattr(self, "compensated", False)

    def _pair(self, value: Any, weight: Any) -> Tuple[torch.Tensor, torch.Tensor]:
        value = _as_float(value, self._device)
        weight = _as_float(weight, value.device).to(value.dtype).broadcast_to(value.shape)
        return value, weight

    def _health_prescreen(self, args: Any, kwargs: Any) -> Any:
        """Broadcast the weight against the value and flatten the pair, so
        masking drops (value, weight) elements together."""
        value = kwargs.get("value", args[0] if args else None)
        if value is None:
            return args, kwargs
        weighted = "weight" in kwargs or len(args) > 1
        value, weight = self._pair(value, kwargs.get("weight", args[1] if len(args) > 1 else 1.0))
        if value.ndim >= 2:
            value, weight = value.reshape(-1), weight.reshape(-1)
        # an unweighted call stays one argument (a subclass may take only the value)
        return ((value, weight) if weighted else (value,)), {}

    def update(self, value: Union[float, torch.Tensor], weight: Union[float, torch.Tensor] = 1.0) -> None:
        value, weight = self._pair(value, weight)
        value, weight = self._fill(value), self._fill(weight)
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

"""Track a metric over steps (epochs) and query the best value (counterpart
of ``metrics_tpu/wrappers/tracker.py``): a plain container, not a
``Metric``. Each ``increment()`` appends a fresh clone of the base metric,
and the lifecycle calls go to the newest."""
from typing import Any, Dict, List, Union

import torch

from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.metric import Metric

__all__ = ["MetricTracker"]


class MetricTracker:
    """Keep one metric (or collection) per tracked step. With a
    ``MetricCollection``, ``compute_all`` and ``best_metric`` return dicts
    keyed by member, and ``maximize`` may be a list of bools, one a member.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanSquaredError, MetricTracker
        >>> tracker = MetricTracker(MeanSquaredError(device="cpu"), maximize=False)
        >>> for noise in (0.5, 0.1, 0.3):
        ...     tracker.increment()
        ...     tracker.update(torch.tensor([1.0 + noise]), torch.tensor([1.0]))
        >>> print(round(float(tracker.best_metric()), 4))
        0.01
    """

    def __init__(self, metric: Union[Metric, MetricCollection], maximize: Union[bool, List[bool]] = True) -> None:
        if not isinstance(metric, (Metric, MetricCollection)):
            raise TypeError(f"metric arg need to be an instance of a metrics_tpu_torch metric but got {metric}")
        self._base_metric = metric
        if not isinstance(maximize, (bool, list)):
            raise ValueError(f"Argument `maximize` should be a bool or list of bools, got {maximize!r}")
        if isinstance(maximize, list):
            if not all(isinstance(m, bool) for m in maximize):
                raise ValueError("Every element of a `maximize` list must be a bool")
            if not isinstance(metric, MetricCollection):
                raise ValueError("A list of `maximize` values requires a MetricCollection base")
            keys = list(metric.keys())
            if len(maximize) != len(keys):
                raise ValueError(f"`maximize` list length {len(maximize)} must match the collection size {len(keys)}")
            self._maximize_per_key = dict(zip(keys, maximize))
        else:
            self._maximize_per_key = None
        self.maximize = maximize
        self._steps: List[Any] = []
        self._increment_called = False

    @property
    def n_steps(self) -> int:
        """Number of times the tracker has been incremented."""
        return len(self._steps)

    def __len__(self) -> int:
        return len(self._steps)

    def __getitem__(self, idx: int) -> Any:
        return self._steps[idx]

    def increment(self) -> None:
        """Start a new step with a fresh clone of the base metric."""
        self._increment_called = True
        clone = self._base_metric.clone()
        clone.reset()
        self._steps.append(clone)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        self._check_for_increment("forward")
        return self._steps[-1](*args, **kwargs)

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._check_for_increment("update")
        self._steps[-1].update(*args, **kwargs)

    def compute(self) -> Any:
        self._check_for_increment("compute")
        return self._steps[-1].compute()

    def compute_all(self) -> Union[torch.Tensor, Dict[str, Any]]:
        """Every step's value stacked on a leading step axis; for a
        collection, a dict of stacks, where a member whose values do not
        stack (a dict, ragged curves) keeps its per-step list."""
        self._check_for_increment("compute_all")
        vals = [m.compute() for m in self._steps]
        if isinstance(self._base_metric, MetricCollection):
            out: Dict[str, Any] = {}
            for k in vals[0]:
                per_step = [v[k] for v in vals]
                try:
                    out[k] = torch.stack([torch.as_tensor(v) for v in per_step], dim=0)
                except (TypeError, ValueError, RuntimeError):
                    out[k] = per_step
            return out
        return torch.stack([torch.as_tensor(v) for v in vals], dim=0)

    def reset(self) -> None:
        """Reset the current step's metric."""
        self._check_for_increment("reset")
        self._steps[-1].reset()

    def reset_all(self) -> None:
        for m in self._steps:
            m.reset()

    def best_metric(self, return_step: bool = False) -> Any:
        """The best value over the steps and, with ``return_step``, its step;
        for a collection, dicts over the members with scalar values."""
        vals = self.compute_all()
        if isinstance(vals, dict):

            def _key_max(k: str) -> bool:
                if self._maximize_per_key is not None:
                    return self._maximize_per_key[k]
                return bool(self.maximize)

            scalar_keys = [k for k, v in vals.items() if not isinstance(v, list) and v.ndim == 1]
            idx = {k: int(vals[k].argmax() if _key_max(k) else vals[k].argmin()) for k in scalar_keys}
            best = {k: float(vals[k][idx[k]]) for k in scalar_keys}
            if return_step:
                return idx, best
            return best
        idx = int(vals.argmax() if self.maximize else vals.argmin())
        best = float(vals[idx])
        if return_step:
            return idx, best
        return best

    # the per-step clones hold the counters; keyed ``step_<i>``
    def compile_stats(self) -> Dict[str, Any]:
        return {"steps": {f"step_{i}": m.compile_stats() for i, m in enumerate(self._steps)}}

    def sync_report(self) -> Dict[str, Any]:
        return {"steps": {f"step_{i}": m.sync_report() for i, m in enumerate(self._steps)}}

    def health_report(self) -> Dict[str, Any]:
        return {"steps": {f"step_{i}": m.health_report() for i, m in enumerate(self._steps)}}

    def obs_snapshot(self) -> Dict[str, Any]:
        """One snapshot per tracked step, newest last, each the full
        ``obs_snapshot()`` of that step's metric or collection."""
        return {
            "class": "MetricTracker",
            "n_steps": self.n_steps,
            "steps": {f"step_{i}": m.obs_snapshot() for i, m in enumerate(self._steps)},
        }

    def _check_for_increment(self, method: str) -> None:
        if not self._increment_called:
            raise ValueError(f"`{method}` cannot be called before `.increment()` has been called")

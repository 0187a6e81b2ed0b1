"""``MetricCollection``: a dict of metrics with one lifecycle (counterpart of
``metrics_tpu/collections.py`` without its fused programs, which wait for
the engine). Each call goes to every member in turn; each member syncs in
its own ``compute()``."""
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.obs.warn import warn_once


class MetricCollection(nn.ModuleDict):
    """Metrics sharing one ``update``/``forward``/``compute``/``reset`` call,
    with per-member kwarg routing and prefix/postfix renaming of results.

    Args:
        metrics: one metric, a list or tuple of metrics (keyed by class
            name), or a dict name -> metric (kept in sorted key order).
        additional_metrics: more metrics appended to a single/sequence input.
        prefix: string prepended to all result keys.
        postfix: string appended to all result keys.

    ``state_dict`` keys are ``"<member>.<state>"``, as in the JAX package.
    """

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        *additional_metrics: Metric,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
    ) -> None:
        super().__init__()
        self.prefix = self._check_arg(prefix, "prefix")
        self.postfix = self._check_arg(postfix, "postfix")
        self.add_metrics(metrics, *additional_metrics)

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Every member's ``forward``: accumulate and return the batch values."""
        return {self._set_name(k): m(*args, **m._filter_kwargs(**kwargs)) for k, m in self.items(keep_base=True)}

    def update(self, *args: Any, **kwargs: Any) -> None:
        for _, m in self.items(keep_base=True):
            m.update(*args, **m._filter_kwargs(**kwargs))

    def compute(self) -> Dict[str, Any]:
        return {self._set_name(k): m.compute() for k, m in self.items(keep_base=True)}

    def reset(self) -> None:
        for _, m in self.items(keep_base=True):
            m.reset()

    def persistent(self, mode: bool = True) -> None:
        for _, m in self.items(keep_base=True):
            m.persistent(mode)

    # -- pure (explicitly state-passing) API -----------------------------
    def init_state(self) -> Dict[str, Dict[str, Any]]:
        """Fresh per-member states, keyed like ``compute`` results. A metric
        registered under two keys gets two independent states here."""
        return {k: m.init_state() for k, m in self.items()}

    def update_state(self, states: Dict[str, Dict[str, Any]], *args: Any, **kwargs: Any) -> Dict[str, Dict[str, Any]]:
        """Pure update of every member, with per-member kwarg routing."""
        return {k: m.update_state(states[k], *args, **m._filter_kwargs(**kwargs)) for k, m in self.items()}

    def sync_state(
        self, states: Dict[str, Dict[str, Any]], process_group: Optional[Any] = None
    ) -> Dict[str, Dict[str, Any]]:
        """Every member's state gathered over ``process_group`` (each
        member's own group when None) and reduced, member by member in key
        order, so every rank issues the same collectives."""
        return {k: m.sync_state(states[k], process_group=process_group) for k, m in self.items()}

    def compute_state(self, states: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
        """Pure compute: ``states -> {key: value}``."""
        return {k: m.compute_state(states[k]) for k, m in self.items()}

    def merge_states(
        self, states_a: Dict[str, Dict[str, Any]], states_b: Dict[str, Dict[str, Any]]
    ) -> Dict[str, Dict[str, Any]]:
        """Merge two independently accumulated collection states, member by member."""
        return {k: m.merge_states(states_a[k], states_b[k]) for k, m in self.items()}

    def to_device(self, device: Union[str, torch.device]) -> "MetricCollection":
        for _, m in self.items(keep_base=True):
            m.to_device(device)
        return self

    def astype(self, dtype: torch.dtype) -> "MetricCollection":
        """Cast every member's current floating-point states to ``dtype``."""
        for _, m in self.items(keep_base=True):
            m.astype(dtype)
        return self

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MetricCollection":
        """A deep copy of every member under the same keys; ``prefix`` and
        ``postfix`` replace this collection's where given, else are kept."""
        mc = MetricCollection({k: m.clone() for k, m in self._modules.items()})
        mc.prefix = self._check_arg(prefix, "prefix") if prefix is not None else self.prefix
        mc.postfix = self._check_arg(postfix, "postfix") if postfix is not None else self.postfix
        return mc

    def add_metrics(
        self, metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]], *additional_metrics: Metric
    ) -> None:
        """Register members: lists key by class name (duplicates forbidden),
        dicts keep user keys in sorted order."""
        if isinstance(metrics, Metric):
            metrics = [metrics]
        if isinstance(metrics, Sequence):
            metrics = list(metrics)
            remain: list = []
            for m in additional_metrics:
                (metrics if isinstance(m, Metric) else remain).append(m)
            if remain:
                warn_once(f"You have passes extra arguments {remain} which are not Metrics and will be ignored.")
        elif additional_metrics:
            raise ValueError(
                f"You have passes extra arguments {additional_metrics} which are not compatible with mapping input."
            )

        if isinstance(metrics, dict):
            for name in sorted(metrics.keys()):
                metric = metrics[name]
                if isinstance(metric, Metric):
                    self[name] = metric
                elif isinstance(metric, MetricCollection):
                    for k, v in metric.items(keep_base=False):
                        self[f"{name}_{k}"] = v
                else:
                    raise ValueError(
                        f"Value {metric} belonging to key {name} is not an instance of `Metric` or `MetricCollection`"
                    )
        elif isinstance(metrics, Sequence):
            for metric in metrics:
                if isinstance(metric, MetricCollection):
                    for k, v in metric.items(keep_base=False):
                        self[k] = v
                    continue
                if not isinstance(metric, Metric):
                    raise ValueError(f"Input {metric} to `MetricCollection` is not a instance of `Metric`")
                name = metric.__class__.__name__
                if name in self:
                    raise ValueError(f"Encountered two metrics both named {name}")
                self[name] = metric
        else:
            raise ValueError("Unknown input to MetricCollection.")

    @staticmethod
    def _check_arg(arg: Optional[str], name: str) -> Optional[str]:
        if arg is None or isinstance(arg, str):
            return arg
        raise ValueError(f"Expected input `{name}` to be a string, but got {type(arg)}")

    def _set_name(self, base: str) -> str:
        name = base if self.prefix is None else self.prefix + base
        return name if self.postfix is None else name + self.postfix

    def items(self, keep_base: bool = False) -> Iterable[Tuple[str, Metric]]:  # type: ignore[override]
        if keep_base:
            return list(self._modules.items())
        return [(self._set_name(k), v) for k, v in self._modules.items()]

    def keys(self, keep_base: bool = False) -> Iterable[str]:  # type: ignore[override]
        if keep_base:
            return list(self._modules.keys())
        return [self._set_name(k) for k in self._modules.keys()]

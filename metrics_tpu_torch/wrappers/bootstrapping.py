"""Bootstrapped confidence intervals for any metric (counterpart of
``metrics_tpu/wrappers/bootstrapping.py``).

Every update resamples the batch along dimension 0, once per replicate.
The indices are drawn on the host from ``numpy.random.default_rng(seed)``,
the same draws in the same order as the JAX package, so on one seed the
replicates of the two packages are the same resamples.

* **Fast path** (``sampling_strategy="multinomial"``, a template that runs
  through the engine, no list state, no process group): the template's
  states carry a leading ``[B]`` axis, and one program advances all ``B``
  replicates (``engine.cache.bootstrap_transition``: a CUDA graph per input
  signature on the card, replayed every batch after the first). The
  ``[B, N]`` indices are copied to the card before the replay (from pinned
  memory, without a host sync), since a capture cannot hold a copy from the
  host. If the first batch cannot run this way, the wrapper falls back to
  the clones below for good.
* **Clones** (poisson resampling, whose resampled batches vary in length,
  and the other cases): ``B`` clones of the metric, each updated eagerly on
  its resampled batch.
"""
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from metrics_tpu_torch.engine import _tree
from metrics_tpu_torch.engine import cache as _engine
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.parallel import comm
from metrics_tpu_torch.utils.data import apply_to_collection

_ALLOWED_SAMPLING = ("poisson", "multinomial")


def _bootstrap_sampler(rng: np.random.Generator, size: int, sampling_strategy: str = "poisson") -> np.ndarray:
    """Indices of ``[0, size)`` drawn with replacement: ``poisson`` repeats
    each index ``n ~ Poisson(1)`` times (a resample of varying length),
    ``multinomial`` draws exactly ``size`` indices uniformly."""
    if sampling_strategy == "poisson":
        counts = rng.poisson(1.0, size=size)
        return np.repeat(np.arange(size), counts)
    if sampling_strategy == "multinomial":
        return rng.integers(0, size, size=size)
    raise ValueError("Unknown sampling strategy")


def _to_device(idx: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host indices on ``device``; to the card from pinned memory, so the
    copy does not wait for the work queued before it."""
    t = torch.from_numpy(np.ascontiguousarray(idx))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class BootStrapper(Metric):
    """Mean, standard deviation and quantiles of a metric's value over
    bootstrap resamples of every update batch.

    Args:
        base_metric: the metric to bootstrap.
        num_bootstraps: the number of replicates ``B``.
        mean, std, quantile, raw: which statistics ``compute`` returns
            (``std`` with one degree of freedom, ``quantile`` by linear
            interpolation, ``raw`` the ``[B, ...]`` replicate values).
        sampling_strategy: ``"poisson"`` (the default: resamples of varying
            length, eager clones) or ``"multinomial"`` (fixed length: one
            program for all replicates).
        seed: the seed of the host sampler; ``reset()`` reseeds.

    The wrapper lives on its base metric's device unless ``device`` is given.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import BootStrapper, MeanSquaredError
        >>> boot = BootStrapper(MeanSquaredError(device="cpu"), num_bootstraps=20)
        >>> boot.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> print(sorted(boot.compute().keys()))
        ['mean', 'std']
    """

    full_state_update = True

    def __init__(
        self,
        base_metric: Metric,
        num_bootstraps: int = 10,
        mean: bool = True,
        std: bool = True,
        quantile: Optional[Union[float, Sequence[float]]] = None,
        raw: bool = False,
        sampling_strategy: str = "poisson",
        seed: int = 42,
        **kwargs: Any,
    ) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of metrics_tpu_torch.Metric but received {base_metric}"
            )
        if sampling_strategy not in _ALLOWED_SAMPLING:
            raise ValueError(
                f"Expected argument ``sampling_strategy`` to be one of {_ALLOWED_SAMPLING}"
                f" but received {sampling_strategy}"
            )
        # the wrapper's update drives its children; the fast path is a program of its own
        kwargs.setdefault("jit_update", False)
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)
        self.num_bootstraps = num_bootstraps
        self.mean = mean
        self.std = std
        self.quantile = quantile
        self.raw = raw
        self.sampling_strategy = sampling_strategy
        self._seed = seed
        self._rng = np.random.default_rng(seed)

        self._template = base_metric.clone()
        self._template.reset()
        # the eager clones: resampled batch lengths vary, a program per length
        self.metrics = nn.ModuleList()
        for _ in range(num_bootstraps):
            m = base_metric.clone()
            m.reset()
            m._enable_jit = False
            self.metrics.append(m)

        self._stacked_state: Optional[Dict[str, torch.Tensor]] = None
        self._use_fast_path: Optional[bool] = None  # decided at the first update

    def _fast_path_eligible(self) -> bool:
        t = self._template
        return (
            self.sampling_strategy == "multinomial"
            and t._enable_jit
            and not t._jit_failed
            and not t._has_list_state()
            and bool(t._defaults)
            and not comm.distributed_available()
        )

    @staticmethod
    def _sample_size(args: Any, kwargs: Any) -> int:
        leaves, _ = _tree.flatten((args, kwargs))
        sizes = [len(x) for x in leaves if isinstance(x, torch.Tensor)]
        if not sizes:
            raise ValueError("None of the input contained tensors, so could not determine the sampling size")
        return sizes[0]

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """One update, then the running statistics: every replicate updates
        once per batch (``Metric.forward``'s batch-state pass would update
        each twice)."""
        self.update(*args, **kwargs)
        self._forward_cache = self.compute() if self.compute_on_step else None
        return self._forward_cache

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Resample the batch per replicate and advance every replicate."""
        size = self._sample_size(args, kwargs)
        if self._use_fast_path is None:
            # decided at the first batch, which has no fast-path state to strand
            if self._fast_path_eligible():
                try:
                    self._fast_update(size, args, kwargs)
                    self._use_fast_path = True
                    return
                except Exception:  # noqa: BLE001 - any failure of the first batch falls back to the clones
                    self._stacked_state = None
            self._use_fast_path = False
        if self._use_fast_path:
            self._fast_update(size, args, kwargs)
            return
        for m in self.metrics:
            rows = _to_device(_bootstrap_sampler(self._rng, size, self.sampling_strategy), self.device)
            new_args = apply_to_collection(args, torch.Tensor, lambda x: x.index_select(0, rows.to(x.device)))
            new_kwargs = apply_to_collection(kwargs, torch.Tensor, lambda x: x.index_select(0, rows.to(x.device)))
            m.update(*new_args, **new_kwargs)

    def _fast_update(self, size: int, args: Any, kwargs: Any) -> None:
        idx = _to_device(self._rng.integers(0, size, size=(self.num_bootstraps, size)), self.device)
        if self._stacked_state is None:
            self._stacked_state = {
                n: v.unsqueeze(0).expand(self.num_bootstraps, *v.shape).clone()
                for n, v in self._template.init_state().items()
            }
        self._stacked_state = _engine.bootstrap_transition(self._template, self._stacked_state, idx, args, kwargs)

    def _replicate_values(self) -> torch.Tensor:
        if self._use_fast_path and self._stacked_state is not None:
            vals = [
                self._template.compute_state({n: v[b] for n, v in self._stacked_state.items()})
                for b in range(self.num_bootstraps)
            ]
        else:
            vals = [m.compute() for m in self.metrics]
        return torch.stack([torch.as_tensor(v) for v in vals], dim=0)

    def compute(self) -> Dict[str, torch.Tensor]:
        """The statistics over the replicates' values."""
        computed_vals = self._replicate_values()
        output_dict: Dict[str, torch.Tensor] = {}
        if self.mean:
            output_dict["mean"] = computed_vals.mean(dim=0)
        if self.std:
            output_dict["std"] = computed_vals.std(dim=0, correction=1)
        if self.quantile is not None:
            q = torch.as_tensor(self.quantile, dtype=computed_vals.dtype, device=computed_vals.device)
            output_dict["quantile"] = torch.quantile(computed_vals, q, dim=0)
        if self.raw:
            output_dict["raw"] = computed_vals
        return output_dict

    def reset(self) -> None:
        super().reset()
        self._stacked_state = None
        self._rng = np.random.default_rng(self._seed)
        for m in self.metrics:
            m.reset()

    def _children(self) -> Dict[str, Metric]:
        """``template`` holds the fast path's counters (its captures and
        cache hits); ``bootstrap_<i>`` the clones'."""
        out: Dict[str, Metric] = {"template": self._template}
        for i, m in enumerate(self.metrics):
            out[f"bootstrap_{i}"] = m
        return out

    def _apply(self, fn: Callable, *args: Any, **kwargs: Any) -> "BootStrapper":
        super()._apply(fn, *args, **kwargs)
        if self._stacked_state is not None:
            self._stacked_state = {n: fn(v) for n, v in self._stacked_state.items()}
        return self

"""KLDivergence module metric (counterpart of ``metrics_tpu/classification/kl_divergence.py``)."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.classification.kl_divergence import _kld_compute, _kld_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat


class KLDivergence(Metric):
    """``D_KL(P || Q)`` over the rows seen.

    Args:
        log_prob: ``p`` and ``q`` are log-probabilities (else probabilities,
            normalized per row).
        reduction: ``"mean"`` or ``"sum"`` over rows (a float sum state), or
            ``"none"``/``None``: every row's value (a ``cat`` list state,
            updated eagerly, as in the JAX package).
        kwargs: see :class:`~metrics_tpu_torch.metric.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import KLDivergence
        >>> kl = KLDivergence(device="cpu")
        >>> print(round(float(kl(torch.tensor([[0.3, 0.7]]), torch.tensor([[0.5, 0.5]]))), 4))
        0.0823
    """

    is_differentiable = True
    higher_is_better = False

    def __init__(self, log_prob: bool = False, reduction: Optional[str] = "mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(log_prob, bool):
            raise TypeError(f"Expected argument `log_prob` to be bool but got {log_prob}")
        self.log_prob = log_prob
        allowed_reduction = ["mean", "sum", "none", None]
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.reduction = reduction
        if self.reduction in ["mean", "sum"]:
            self.add_state("measures", torch.tensor(0.0), dist_reduce_fx="sum")
        else:
            self.add_state("measures", [], dist_reduce_fx="cat")
        self.add_state("total", torch.tensor(0), dist_reduce_fx="sum")

    def update(self, p: torch.Tensor, q: torch.Tensor) -> None:
        measures, total = _kld_update(p, q, self.log_prob)
        if self.reduction is None or self.reduction == "none":
            self.measures.append(measures)
        else:
            self.measures = self.measures + measures.sum()
        self.total = self.total + total

    def compute(self) -> torch.Tensor:
        measures = dim_zero_cat(self.measures) if self.reduction in ["none", None] else self.measures
        return _kld_compute(measures, self.total, self.reduction)

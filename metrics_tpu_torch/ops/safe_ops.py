"""Numerical guards (counterpart of ``metrics_tpu/ops/safe_ops.py``)."""
from typing import Tuple

import torch


def safe_divide(num: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """Division that treats 0/0 as 0: zero denominators are replaced by 1, so
    the result is ``num/denom`` where ``denom != 0`` and ``num`` elsewhere."""
    denom = torch.as_tensor(denom)
    return num / torch.where(denom == 0, torch.ones_like(denom), denom)


def kahan_add(total: torch.Tensor, comp: torch.Tensor, delta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of Kahan (compensated) summation: ``total + delta`` with the
    running low-order error carried in ``comp``. Returns ``(total', comp')``.

    The compensation recovers the bits an ``x + tiny`` float add drops, so a
    float32 running sum keeps close to float64 accuracy over millions of
    streaming updates at the cost of 3 extra adds.
    """
    y = delta - comp
    t = total + y
    comp = (t - total) - y
    return t, comp

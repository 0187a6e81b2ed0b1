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


def saturating_add(acc: torch.Tensor, delta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer add that clamps at the dtype's maximum instead of wrapping.

    ``delta`` is a non-negative counter increment. Returns ``(result,
    overflowed)``: ``overflowed`` is a 0-d bool tensor, True when an element
    would have wrapped past ``iinfo(acc.dtype).max``; those elements hold the
    maximum, a visibly pegged count instead of a negative one. No host sync.
    """
    out = acc + delta
    wrapped = out < acc  # with a non-negative delta, a decrease is a wrap
    peak = torch.full_like(out, torch.iinfo(out.dtype).max)
    return torch.where(wrapped, peak, out), wrapped.any()

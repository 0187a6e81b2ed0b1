"""Numerical guards (counterpart of ``metrics_tpu/ops/safe_ops.py``)."""
import torch


def safe_divide(num: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """Division that treats 0/0 as 0: zero denominators are replaced by 1, so
    the result is ``num/denom`` where ``denom != 0`` and ``num`` elsewhere."""
    denom = torch.as_tensor(denom)
    return num / torch.where(denom == 0, torch.ones_like(denom), denom)

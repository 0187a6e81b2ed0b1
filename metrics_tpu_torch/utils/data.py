"""Tensor utilities: dim-0 reductions, one-hot, top-k, collection map,
bincount and the threshold grid (counterpart of ``metrics_tpu/utils/data.py``)."""
from collections.abc import Mapping, Sequence
from typing import Any, Callable, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.ops.select_topk import select_topk_mask

METRIC_EPS = 1e-6


def dim_zero_cat(x: Union[torch.Tensor, List[torch.Tensor], Tuple[torch.Tensor, ...]]) -> torch.Tensor:
    """Concatenate a list of tensors along dim 0; 0-d entries become ``(1,)``."""
    if isinstance(x, torch.Tensor):
        return x
    x = [xi.unsqueeze(0) if xi.ndim == 0 else xi for xi in x]
    if not x:
        raise ValueError("No samples to concatenate")
    return x[0] if len(x) == 1 else torch.cat(x, dim=0)


def dim_zero_sum(x: Any) -> torch.Tensor:
    return dim_zero_cat(x).sum(dim=0)


def dim_zero_mean(x: Any) -> torch.Tensor:
    return dim_zero_cat(x).mean(dim=0)


def dim_zero_max(x: Any) -> torch.Tensor:
    return dim_zero_cat(x).max(dim=0).values


def dim_zero_min(x: Any) -> torch.Tensor:
    return dim_zero_cat(x).min(dim=0).values


def to_onehot(label_tensor: torch.Tensor, num_classes: Optional[int] = None) -> torch.Tensor:
    """Integer labels ``(N, ...)`` to int32 one-hot ``(N, C, ...)``.

    A comparison against ``arange(C)`` rather than ``F.one_hot``: a label
    outside ``[0, C)`` gives a zero row, as ``jax.nn.one_hot`` does, instead
    of a device-side assert.
    """
    if num_classes is None:
        num_classes = int(label_tensor.max().item()) + 1
    classes = torch.arange(num_classes, device=label_tensor.device).reshape(1, -1, *([1] * (label_tensor.ndim - 1)))
    return (label_tensor.unsqueeze(1) == classes).to(torch.int32)


def select_topk(prob_tensor: torch.Tensor, topk: int = 1, dim: int = 1) -> torch.Tensor:
    """Binarize by top-k along ``dim``: int32 0/1 mask.

    k = 1 is an argmax (first maximum wins, NaN is greatest); k > 1 goes to
    the ``select_topk`` kernel over the rows of a 2-D view.
    """
    if topk == 1:
        idx = prob_tensor.argmax(dim=dim, keepdim=True)
        return torch.zeros(prob_tensor.shape, dtype=torch.int32, device=prob_tensor.device).scatter_(dim, idx, 1)
    moved = prob_tensor.movedim(dim, -1)
    mask = select_topk_mask(moved.reshape(-1, moved.shape[-1]), topk)
    return mask.reshape(moved.shape).movedim(-1, dim)


def to_categorical(x: torch.Tensor, argmax_dim: int = 1) -> torch.Tensor:
    """Probabilities or one-hot to integer labels."""
    return x.argmax(dim=argmax_dim)


def apply_to_collection(
    data: Any,
    dtype: Union[type, tuple],
    function: Callable,
    *args: Any,
    wrong_dtype: Optional[Union[type, tuple]] = None,
    **kwargs: Any,
) -> Any:
    """Recursively apply ``function`` to all ``dtype`` elements of a collection."""
    if isinstance(data, dtype) and (wrong_dtype is None or not isinstance(data, wrong_dtype)):
        return function(data, *args, **kwargs)
    if isinstance(data, Mapping):
        return type(data)(
            {k: apply_to_collection(v, dtype, function, *args, wrong_dtype=wrong_dtype, **kwargs) for k, v in data.items()}
        )
    if isinstance(data, tuple) and hasattr(data, "_fields"):  # namedtuple
        return type(data)(*(apply_to_collection(d, dtype, function, *args, wrong_dtype=wrong_dtype, **kwargs) for d in data))
    if isinstance(data, Sequence) and not isinstance(data, str):
        return type(data)(apply_to_collection(d, dtype, function, *args, wrong_dtype=wrong_dtype, **kwargs) for d in data)
    return data


def _squeeze_if_scalar(data: Any) -> Any:
    """Squeeze 1-element tensors to 0-d."""
    return apply_to_collection(data, torch.Tensor, lambda x: x.squeeze() if x.numel() == 1 else x)


def _bincount(x: torch.Tensor, minlength: int) -> torch.Tensor:
    """Counts of ``0..minlength-1``: exactly ``minlength`` bins (larger values dropped)."""
    return torch.bincount(x.reshape(-1), minlength=minlength)[:minlength]


def _linspace(start: float, stop: float, num: int, dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """``num`` evenly spaced values from ``start`` to ``stop``, computed as
    ``jnp.linspace`` computes them (``start + i * step``, then ``stop``), so
    the bin boundaries and thresholds of the curve and calibration metrics
    sit on the same values as in the JAX package. (``torch.linspace`` counts
    its second half down from ``stop`` and differs in the last bit.)"""
    if num == 1:
        return torch.full((1,), start, dtype=dtype, device=device)
    first = torch.tensor(start, dtype=dtype, device=device)
    step = (torch.tensor(stop, dtype=dtype, device=device) - first) / (num - 1)
    grid = first + torch.arange(num - 1, dtype=dtype, device=device) * step
    return torch.cat([grid, torch.full((1,), stop, dtype=dtype, device=device)])

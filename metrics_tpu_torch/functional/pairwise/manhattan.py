"""Pairwise manhattan distance (counterpart of
``metrics_tpu/functional/pairwise/manhattan.py``): a broadcast ``[N, M, d]``
difference, as in the JAX package, which has no kernel for it."""
from typing import Optional

import torch

from metrics_tpu_torch.functional.pairwise.helpers import _check_input, _promote, _reduce_distance_matrix, _zero_diagonal


def _pairwise_manhattan_distance_update(
    x: torch.Tensor, y: Optional[torch.Tensor] = None, zero_diagonal: Optional[bool] = None
) -> torch.Tensor:
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    x, y = _promote(x, y)
    distance = (x[:, None, :] - y[None, :, :]).abs().sum(dim=-1)
    return _zero_diagonal(distance, zero_diagonal)


def pairwise_manhattan_distance(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> torch.Tensor:
    """Pairwise L1 distance between rows of ``x`` (``[N, d]``) and ``y`` (``[M, d]``).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import pairwise_manhattan_distance
        >>> x = torch.tensor([[1.0, 2.0], [3.0, 5.0]])
        >>> print(pairwise_manhattan_distance(x).tolist())
        [[0.0, 5.0], [5.0, 0.0]]
    """
    distance = _pairwise_manhattan_distance_update(x, y, zero_diagonal)
    return _reduce_distance_matrix(distance, reduction)

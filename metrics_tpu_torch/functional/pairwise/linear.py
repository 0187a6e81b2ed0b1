"""Pairwise linear (dot-product) similarity (counterpart of
``metrics_tpu/functional/pairwise/linear.py``): one ``torch.matmul``; the
JAX package has no kernel for it."""
from typing import Optional

import torch

from metrics_tpu_torch.functional.pairwise.helpers import _check_input, _promote, _reduce_distance_matrix, _zero_diagonal


def _pairwise_linear_similarity_update(
    x: torch.Tensor, y: Optional[torch.Tensor] = None, zero_diagonal: Optional[bool] = None
) -> torch.Tensor:
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    x, y = _promote(x, y)
    return _zero_diagonal(x @ y.T, zero_diagonal)


def pairwise_linear_similarity(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> torch.Tensor:
    """Pairwise dot-product similarity between rows of ``x`` (``[N, d]``) and ``y`` (``[M, d]``).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import pairwise_linear_similarity
        >>> x = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
        >>> print(pairwise_linear_similarity(x).tolist())
        [[0.0, 11.0], [11.0, 0.0]]
    """
    distance = _pairwise_linear_similarity_update(x, y, zero_diagonal)
    return _reduce_distance_matrix(distance, reduction)

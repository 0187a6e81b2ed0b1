"""Pairwise euclidean distance (counterpart of
``metrics_tpu/functional/pairwise/euclidean.py``).

Uses the ``||x||² + ||y||² − 2x·y`` expansion. With ``reduction="sum"`` or
``"mean"`` the row sums come from the ``pairwise_reduce`` kernel, which
never builds the ``[N, M]`` matrix; with no reduction the matrix is one
``torch.matmul`` and the same epilogue.
"""
from typing import Optional

import torch

from metrics_tpu_torch.functional.pairwise.helpers import _check_input, _promote, _reduce_distance_matrix, _zero_diagonal
from metrics_tpu_torch.ops.pairwise_reduce import pairwise_reduce_rows


def _pairwise_euclidean_distance_update(
    x: torch.Tensor, y: Optional[torch.Tensor] = None, zero_diagonal: Optional[bool] = None
) -> torch.Tensor:
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    x, y = _promote(x, y, to_float=True)
    x_norm = (x * x).sum(dim=1, keepdim=True)
    y_norm = (y * y).sum(dim=1)[None, :]
    distance = x_norm + y_norm - 2 * (x @ y.T)
    distance = _zero_diagonal(distance, zero_diagonal)
    return distance.clamp(min=0).sqrt()


def pairwise_euclidean_distance(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> torch.Tensor:
    """Pairwise euclidean distance between rows of ``x`` (``[N, d]``) and ``y`` (``[M, d]``).

    Runs on the inputs' device. ``reduction`` is ``"sum"``/``"mean"`` (over
    the M columns; ``"mean"`` divides by M, zeroed diagonal included) or
    ``None``/``"none"`` for the ``[N, M]`` matrix. ``zero_diagonal`` defaults
    to True when ``y`` is None.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import pairwise_euclidean_distance
        >>> x = torch.tensor([[0.0, 0.0], [3.0, 4.0]])
        >>> print(pairwise_euclidean_distance(x).tolist())
        [[0.0, 5.0], [5.0, 0.0]]
    """
    if reduction in ("sum", "mean"):
        xc, yc, zero_diag = _check_input(x, y, zero_diagonal)
        xc, yc = _promote(xc, yc, to_float=True)
        return pairwise_reduce_rows(xc, yc, "euclidean", reduction, zero_diag)
    distance = _pairwise_euclidean_distance_update(x, y, zero_diagonal)
    return _reduce_distance_matrix(distance, reduction)

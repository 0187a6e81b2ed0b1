"""Pairwise cosine similarity (counterpart of
``metrics_tpu/functional/pairwise/cosine.py``).

Rows are normalized here, outside the kernel, as the JAX package does; a
zero row gives NaN (0/0). With ``reduction="sum"`` or ``"mean"`` the row sums
of the normalized product come from the ``pairwise_reduce`` kernel; with no
reduction the matrix is one ``torch.matmul``.
"""
from typing import Optional

import torch

from metrics_tpu_torch.functional.pairwise.helpers import _check_input, _promote, _reduce_distance_matrix, _zero_diagonal
from metrics_tpu_torch.ops.pairwise_reduce import pairwise_reduce_rows


def _normalize_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def _pairwise_cosine_similarity_update(
    x: torch.Tensor, y: Optional[torch.Tensor] = None, zero_diagonal: Optional[bool] = None
) -> torch.Tensor:
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    x, y = _promote(x, y, to_float=True)
    distance = _normalize_rows(x) @ _normalize_rows(y).T
    return _zero_diagonal(distance, zero_diagonal)


def pairwise_cosine_similarity(
    x: torch.Tensor,
    y: Optional[torch.Tensor] = None,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> torch.Tensor:
    """Pairwise cosine similarity between rows of ``x`` (``[N, d]``) and ``y`` (``[M, d]``).

    Runs on the inputs' device; ``reduction`` and ``zero_diagonal`` as in
    :func:`~metrics_tpu_torch.functional.pairwise_euclidean_distance`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import pairwise_cosine_similarity
        >>> x = torch.tensor([[1.0, 0.0]])
        >>> y = torch.tensor([[0.6, 0.8]])
        >>> print(round(float(pairwise_cosine_similarity(x, y)[0, 0]), 4))
        0.6
    """
    if reduction in ("sum", "mean"):
        xc, yc, zero_diag = _check_input(x, y, zero_diagonal)
        xc, yc = _promote(xc, yc, to_float=True)
        xn = _normalize_rows(xc)
        yn = xn if y is None else _normalize_rows(yc)  # x against itself: normalized once
        return pairwise_reduce_rows(xn, yn, "cosine", reduction, zero_diag)
    distance = _pairwise_cosine_similarity_update(x, y, zero_diagonal)
    return _reduce_distance_matrix(distance, reduction)

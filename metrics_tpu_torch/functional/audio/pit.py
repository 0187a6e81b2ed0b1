"""Permutation-invariant training (counterpart of
``metrics_tpu/functional/audio/pit.py``).

* The ``spk x spk`` metric matrix comes from one call of ``metric_func`` on
  the flattened pair grid: ``metric_func`` maps over dim 0.
* Up to ``_EXHAUSTIVE_MAX_SPK`` speakers every permutation is scored by one
  gather and mean; ties go to the first permutation in
  ``itertools.permutations`` order (``torch.argmax`` keeps the first, as
  ``jnp.argmax`` does). The permutation table is made once per speaker
  count and device.
* Past that, scipy's Hungarian ``linear_sum_assignment`` runs on the host:
  one read of the metric matrix, so an update on this path is not captured
  and the metric falls back to its eager update.
"""
from functools import lru_cache
from itertools import permutations
from typing import Any, Callable, Tuple

import numpy as np
import torch

from metrics_tpu_torch.utils.checks import _check_same_shape

_EXHAUSTIVE_MAX_SPK = 6


@lru_cache(maxsize=None)
def _permutation_table(spk: int, device: torch.device) -> torch.Tensor:
    """``[spk!, spk]`` int64: row ``p`` is the ``p``-th permutation of
    ``range(spk)``. Cached, so a captured update reads it and never copies it."""
    return torch.from_numpy(np.asarray(list(permutations(range(spk))), dtype=np.int64)).to(device)


def _metric_matrix(preds: torch.Tensor, target: torch.Tensor, metric_func: Callable, **kwargs: Any) -> torch.Tensor:
    """``mtx[b, j, i] = metric_func(preds[b, i], target[b, j])`` in one call."""
    batch, spk = target.shape[0], target.shape[1]
    tail = tuple(preds.shape[2:])
    # pair grid: target index j varies over axis 1, preds index i over axis 2
    p = preds[:, None].expand((batch, spk, spk) + tail).reshape((batch * spk * spk,) + tail)
    t = target[:, :, None].expand((batch, spk, spk) + tail).reshape((batch * spk * spk,) + tail)
    return metric_func(p, t, **kwargs).reshape(batch, spk, spk)


def _find_best_perm_exhaustive(metric_mtx: torch.Tensor, maximize: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    spk = metric_mtx.shape[1]
    perm_mat = _permutation_table(spk, metric_mtx.device)
    # metric_of_ps[b, p] = mean_j mtx[b, j, perm_mat[p, j]]
    metric_of_ps = metric_mtx[:, torch.arange(spk, device=metric_mtx.device)[None, :], perm_mat].mean(dim=-1)
    best_idx = metric_of_ps.argmax(dim=-1) if maximize else metric_of_ps.argmin(dim=-1)
    best_metric = torch.take_along_dim(metric_of_ps, best_idx[:, None], dim=-1)[:, 0]
    return best_metric, perm_mat[best_idx].to(torch.int32)


def _find_best_perm_lsa(metric_mtx: torch.Tensor, maximize: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    from scipy.optimize import linear_sum_assignment

    mtx_np = metric_mtx.detach().cpu().numpy()
    perm_np = np.stack([linear_sum_assignment(m, maximize)[1] for m in mtx_np]).astype(np.int32)
    best_perm = torch.from_numpy(perm_np).to(metric_mtx.device)
    best_metric = torch.take_along_dim(metric_mtx, best_perm[:, :, None].long(), dim=2)[..., 0].mean(dim=-1)
    return best_metric, best_perm


def permutation_invariant_training(
    preds: torch.Tensor, target: torch.Tensor, metric_func: Callable, eval_func: str = "max", **kwargs: Any
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best metric value over speaker permutations.

    Args:
        preds / target: ``[batch, spk, ...]``.
        metric_func: batch-mapped metric on torch tensors,
            ``metric_func(preds[:, i], target[:, j]) -> [batch]``.
        eval_func: ``"max"`` (higher is better) or ``"min"``.

    Returns:
        ``(best_metric [batch], best_perm [batch, spk] int32)`` where
        ``best_perm[b, j]`` is the prediction index matched to target ``j``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import permutation_invariant_training, scale_invariant_signal_noise_ratio
        >>> preds = torch.tensor([[[-0.1, 0.2, 0.3], [0.4, -0.5, 0.6]]])
        >>> target = torch.tensor([[[0.4, -0.5, 0.6], [-0.1, 0.2, 0.3]]])
        >>> best, perm = permutation_invariant_training(preds, target, scale_invariant_signal_noise_ratio, 'max')
        >>> print(perm[0].tolist())
        [1, 0]
    """
    _check_same_shape(preds, target)
    if eval_func not in ["max", "min"]:
        raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
    if target.ndim < 2:
        raise ValueError(
            f"Inputs must be of shape [batch, spk, ...], got {tuple(target.shape)} and {tuple(preds.shape)} instead"
        )

    metric_mtx = _metric_matrix(preds, target, metric_func, **kwargs)
    if target.shape[1] <= _EXHAUSTIVE_MAX_SPK:
        return _find_best_perm_exhaustive(metric_mtx, maximize=eval_func == "max")
    return _find_best_perm_lsa(metric_mtx, maximize=eval_func == "max")


def pit_permutate(preds: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``preds`` rearranged by the permutation from PIT: output
    ``[b, j] = preds[b, perm[b, j]]``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import pit_permutate
        >>> preds = torch.tensor([[[1.0, 2.0], [3.0, 4.0]]])
        >>> perm = torch.tensor([[1, 0]])
        >>> print(pit_permutate(preds, perm)[0].tolist())
        [[3.0, 4.0], [1.0, 2.0]]
    """
    perm_exp = perm.long().reshape(tuple(perm.shape) + (1,) * (preds.ndim - 2))
    return torch.take_along_dim(preds, perm_exp, dim=1)

"""Dice score (counterpart of ``metrics_tpu/functional/classification/dice.py``;
functional only, as there).

The per-class counts are one masked reduction over a ``[C', ...]``
comparison of the labels with the class ids."""
import torch

from metrics_tpu_torch.ops.safe_ops import safe_divide
from metrics_tpu_torch.parallel.comm import reduce
from metrics_tpu_torch.utils.data import to_categorical


def dice_score(
    preds: torch.Tensor,
    target: torch.Tensor,
    bg: bool = False,
    nan_score: float = 0.0,
    no_fg_score: float = 0.0,
    reduction: str = "elementwise_mean",
) -> torch.Tensor:
    """Dice ``2 TP / (2 TP + FP + FN)`` per class of one batch.

    Args:
        preds: ``[N, C, ...]`` scores (argmaxed over dim 1) or labels of
            ``target``'s shape (C is then ``preds.shape[1]``).
        target: integer labels.
        bg: score class 0 (the background) too.
        nan_score: the score of a class with ``2 TP + FP + FN = 0``.
        no_fg_score: the score of a class absent from ``target``.
        reduction: ``"elementwise_mean"``, ``"sum"`` or ``"none"``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import dice_score
        >>> preds = torch.tensor([[0.1, 0.9], [0.8, 0.2], [0.3, 0.7]])
        >>> print(round(float(dice_score(preds, torch.tensor([1, 0, 0]))), 4))
        0.6667
    """
    num_classes = preds.shape[1]
    bg_inv = 1 - int(bg)
    pred_labels = to_categorical(preds, argmax_dim=1) if preds.ndim == target.ndim + 1 else preds

    classes = torch.arange(bg_inv, num_classes, device=preds.device)
    p_eq = pred_labels[None, ...] == classes.reshape((-1,) + (1,) * pred_labels.ndim)
    t_eq = target[None, ...] == classes.reshape((-1,) + (1,) * target.ndim)
    sum_dims = tuple(range(1, p_eq.ndim))
    tp = (p_eq & t_eq).sum(dim=sum_dims).to(torch.float32)
    fp = (p_eq & ~t_eq).sum(dim=sum_dims).to(torch.float32)
    fn = (~p_eq & t_eq).sum(dim=sum_dims).to(torch.float32)
    has_fg = t_eq.sum(dim=sum_dims) > 0

    denom = 2 * tp + fp + fn
    score_cls = torch.where(denom != 0, safe_divide(2 * tp, denom), nan_score)
    scores = torch.where(has_fg, score_cls, no_fg_score)
    return reduce(scores, reduction=reduction)

"""Hinge loss (counterpart of ``metrics_tpu/functional/classification/hinge.py``).

Binary, Crammer-Singer and one-vs-all margins, as masked reductions over a
one-hot of the target, so the update runs as one program."""
from typing import Optional, Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _input_squeeze
from metrics_tpu_torch.utils.data import to_onehot
from metrics_tpu_torch.utils.enums import DataType, EnumStr


class MulticlassMode(EnumStr):
    """How a multiclass hinge loss is taken."""

    CRAMMER_SINGER = "crammer-singer"
    ONE_VS_ALL = "one-vs-all"


_MODE_ERROR = (
    "The `multiclass_mode` should be either None / 'crammer-singer' / MulticlassMode.CRAMMER_SINGER"
    "(default) or 'one-vs-all' / MulticlassMode.ONE_VS_ALL,"
)


def _check_shape_and_type_consistency_hinge(preds: torch.Tensor, target: torch.Tensor) -> DataType:
    if target.ndim > 1:
        raise ValueError(f"The `target` should be one dimensional, got `target` with shape={tuple(target.shape)}.")
    if preds.ndim == 1:
        if preds.shape != target.shape:
            raise ValueError(
                "The `preds` and `target` should have the same shape,"
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
            )
        return DataType.BINARY
    if preds.ndim == 2:
        if preds.shape[0] != target.shape[0]:
            raise ValueError(
                "The `preds` and `target` should have the same shape in the first dimension,"
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
            )
        return DataType.MULTICLASS
    raise ValueError(f"The `preds` should be one or two dimensional, got `preds` with shape={tuple(preds.shape)}.")


def _hinge_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    squared: bool = False,
    multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sum of the per-sample losses, number of samples)``: a scalar sum, or
    ``[C]`` sums for one-vs-all."""
    preds, target = _input_squeeze(preds, target)
    mode = _check_shape_and_type_consistency_hinge(preds, target)

    if mode == DataType.MULTICLASS:
        target_oh = to_onehot(target, max(2, preds.shape[1])).bool()

    if mode == DataType.MULTICLASS and (multiclass_mode is None or multiclass_mode == MulticlassMode.CRAMMER_SINGER):
        # the true class's score less the best other class's
        margin = torch.where(target_oh, preds, 0.0).sum(dim=1)
        margin = margin - torch.where(target_oh, float("-inf"), preds).amax(dim=1)
    elif mode == DataType.BINARY or multiclass_mode == MulticlassMode.ONE_VS_ALL:
        tgt = target_oh if mode == DataType.MULTICLASS else target.bool()
        margin = torch.where(tgt, preds, -preds)
    else:
        raise ValueError(_MODE_ERROR + f" got {multiclass_mode}.")

    measures = (1 - margin).clamp(min=0)
    if squared:
        measures = measures**2
    total = torch.full((), target.shape[0], dtype=torch.int64, device=preds.device)
    return measures.sum(dim=0), total


def _hinge_compute(measure: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    return measure / total


def hinge_loss(
    preds: torch.Tensor,
    target: torch.Tensor,
    squared: bool = False,
    multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
) -> torch.Tensor:
    """Mean hinge loss of one batch.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import hinge_loss
        >>> print(round(float(hinge_loss(torch.tensor([-2.2, 2.4, 0.1]), torch.tensor([0, 1, 1]))), 4))
        0.3
    """
    measure, total = _hinge_update(preds, target, squared=squared, multiclass_mode=multiclass_mode)
    return _hinge_compute(measure, total)

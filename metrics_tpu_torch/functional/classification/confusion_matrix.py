"""Confusion matrix (counterpart of
``metrics_tpu/functional/classification/confusion_matrix.py``)."""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.obs.warn import warn_once
from metrics_tpu_torch.ops.confusion_counts import confusion_counts, multilabel_counts
from metrics_tpu_torch.utils.checks import _input_format_classification
from metrics_tpu_torch.utils.data import in_program
from metrics_tpu_torch.utils.enums import DataType


def _confusion_matrix_update(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    threshold: float = 0.5,
    multilabel: bool = False,
    window: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Unnormalized int64 confusion matrix ``[C, C]``, or ``[C, 2, 2]`` when
    ``multilabel=True``, through the ``confusion_counts`` or
    ``multilabel_counts`` kernel; with a class ``window=(c0, W)`` only its
    ``W`` rows (target classes ``c0 .. c0 + W - 1``)."""
    # num_classes goes to the formatter only for integer-label inputs: float
    # scores carry C in their shape, and the binary/multilabel checks reject it
    fmt_num_classes = num_classes if (not preds.is_floating_point() and preds.ndim == target.ndim) else None
    preds, target, mode = _input_format_classification(preds, target, threshold, num_classes=fmt_num_classes)
    if mode not in (DataType.BINARY, DataType.MULTILABEL):
        preds = preds.argmax(dim=1)
        target = target.argmax(dim=1)
    if multilabel:
        return multilabel_counts(preds, target, cols=window)
    return confusion_counts(preds, target, num_classes=num_classes, rows=window)


def _confusion_matrix_compute(confmat: torch.Tensor, normalize: Optional[str] = None) -> torch.Tensor:
    """Apply normalization."""
    allowed_normalize = ("true", "pred", "all", "none", None)
    if normalize not in allowed_normalize:
        raise ValueError(f"Argument average needs to one of the following: {allowed_normalize}")
    if normalize is not None and normalize != "none":
        confmat = confmat.float() if not confmat.is_floating_point() else confmat
        if normalize == "true":
            confmat = confmat / confmat.sum(dim=1, keepdim=True)
        elif normalize == "pred":
            confmat = confmat / confmat.sum(dim=0, keepdim=True)
        elif normalize == "all":
            confmat = confmat / confmat.sum()
        nan_mask = torch.isnan(confmat)
        nan_count = 0 if in_program() else int(nan_mask.sum().item())
        if nan_count:
            warn_once(
                f"{nan_count} nan values found in confusion matrix have been replaced with zeros.",
                key="confusion_matrix_nan_replaced",
            )
        confmat = torch.where(nan_mask, torch.zeros_like(confmat), confmat)
    return confmat


def confusion_matrix(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    normalize: Optional[str] = None,
    threshold: float = 0.5,
    multilabel: bool = False,
) -> torch.Tensor:
    """Confusion matrix of one batch for binary, multiclass or multilabel inputs."""
    confmat = _confusion_matrix_update(preds, target, num_classes, threshold, multilabel)
    return _confusion_matrix_compute(confmat, normalize)

"""HingeLoss module metric (counterpart of ``metrics_tpu/classification/hinge.py``)."""
from typing import Any, Optional, Union

import torch

from metrics_tpu_torch.functional.classification.hinge import (
    _MODE_ERROR,
    MulticlassMode,
    _hinge_compute,
    _hinge_update,
)
from metrics_tpu_torch.metric import Metric


class HingeLoss(Metric):
    """Mean hinge loss: binary, Crammer-Singer or one-vs-all.

    Args:
        squared: square each sample's loss.
        multiclass_mode: ``None`` or ``"crammer-singer"`` (one margin per
            sample), or ``"one-vs-all"`` (a loss per class, ``[C]``).
        kwargs: see :class:`~metrics_tpu_torch.metric.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import HingeLoss
        >>> hinge = HingeLoss(device="cpu")
        >>> print(round(float(hinge(torch.tensor([0.5, -1.0, 2.0]), torch.tensor([1, 0, 1]))), 4))
        0.1667
    """

    is_differentiable = True
    higher_is_better = False
    # one-vs-all turns the scalar ``measure`` into ``[C]``; a rank that never
    # updated keeps the scalar, so the sync exchanges its shape first
    _shape_polymorphic_states = frozenset({"measure"})

    def __init__(
        self,
        squared: bool = False,
        multiclass_mode: Optional[Union[str, MulticlassMode]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.add_state("measure", default=torch.tensor(0.0), dist_reduce_fx="sum")
        self.add_state("total", default=torch.tensor(0), dist_reduce_fx="sum")
        if multiclass_mode not in (None, MulticlassMode.CRAMMER_SINGER, MulticlassMode.ONE_VS_ALL):
            raise ValueError(_MODE_ERROR + f" got {multiclass_mode}.")
        self.squared = squared
        self.multiclass_mode = multiclass_mode

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        measure, total = _hinge_update(preds, target, squared=self.squared, multiclass_mode=self.multiclass_mode)
        self.measure = measure + self.measure
        self.total = total + self.total

    def compute(self) -> torch.Tensor:
        return _hinge_compute(self.measure, self.total)

"""AUC module metric (counterpart of ``metrics_tpu/classification/auc.py``)."""
from typing import Any

import torch

from metrics_tpu_torch.functional.classification.auc import _auc_compute, _auc_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat


class AUC(Metric):
    """Area under an accumulated curve ``y(x)``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import AUC
        >>> auc = AUC(device="cpu")
        >>> print(round(float(auc(torch.tensor([0.0, 0.5, 1.0]), torch.tensor([0.0, 0.5, 1.0]))), 4))
        0.5
    """

    is_differentiable = False
    higher_is_better = None

    def __init__(self, reorder: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.reorder = reorder
        self.add_state("x", default=[], dist_reduce_fx="cat", placeholder=torch.get_default_dtype())
        self.add_state("y", default=[], dist_reduce_fx="cat", placeholder=torch.get_default_dtype())

    def update(self, x: torch.Tensor, y: torch.Tensor) -> None:
        x, y = _auc_update(x, y)
        self.x.append(x)
        self.y.append(y)

    def compute(self) -> torch.Tensor:
        return _auc_compute(dim_zero_cat(self.x), dim_zero_cat(self.y), reorder=self.reorder)

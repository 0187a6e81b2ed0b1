"""CosineSimilarity module metric (counterpart of ``metrics_tpu/regression/cosine_similarity.py``)."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.regression.cosine_similarity import (
    _cosine_similarity_compute,
    _cosine_similarity_update,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.data import dim_zero_cat


class CosineSimilarity(Metric):
    """Row-wise cosine similarity, buffered so any reduction can apply at compute.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import CosineSimilarity
        >>> cosine = CosineSimilarity(reduction="mean", device="cpu")
        >>> print(round(float(cosine(torch.tensor([[1.0, 0.0]]), torch.tensor([[0.6, 0.8]]))), 4))
        0.6
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(self, reduction: Optional[str] = "sum", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        allowed_reduction = ("sum", "mean", "none", None)
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.reduction = reduction
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target = _cosine_similarity_update(preds, target)
        self.preds.append(preds)
        self.target.append(target)

    def compute(self) -> torch.Tensor:
        return _cosine_similarity_compute(dim_zero_cat(self.preds), dim_zero_cat(self.target), self.reduction)

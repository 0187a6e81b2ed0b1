"""AveragePrecision module metric (counterpart of
``metrics_tpu/classification/avg_precision.py``): buffers the samples (or a
fixed ``buffer_capacity`` of them) and computes the exact score."""
from typing import Any, List, Optional, Union

import torch

from metrics_tpu_torch.functional.classification.average_precision import (
    _average_precision_compute,
    _average_precision_update,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.bounded import _BoundedSampleBufferMixin, curve_buffer_specs


class AveragePrecision(_BoundedSampleBufferMixin, Metric):
    """Average precision score.

    Args:
        num_classes: class count for multiclass or multilabel inputs.
        pos_label: positive-class label for binary inputs.
        average: ``micro``, ``macro``, ``weighted`` or ``none``/``None``.
        buffer_capacity: fix the sample buffers to this many entries (exact,
            overflow checked); with ``average="micro"`` inputs are flattened
            first, so it counts elements, not samples.
        multilabel: with ``buffer_capacity``, updates carry ``[N, num_classes]`` targets.
        device: see :class:`~metrics_tpu_torch.metric.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import AveragePrecision
        >>> ap = AveragePrecision(device="cpu")
        >>> ap.update(torch.tensor([0.1, 0.4, 0.6, 0.9]), torch.tensor([0, 0, 1, 1]))
        >>> print(round(float(ap.compute()), 4))
        1.0
    """

    is_differentiable = False
    higher_is_better = True
    _dynamic_state_attrs = ("num_classes", "pos_label")

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        average: Optional[str] = "macro",
        buffer_capacity: Optional[int] = None,
        multilabel: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.pos_label = pos_label
        allowed_average = ("micro", "macro", "weighted", "none", None)
        if average not in allowed_average:
            raise ValueError(f"Expected argument `average` to be one of {allowed_average} but got {average}")
        self.average = average
        # micro flattens equal-rank inputs to 1-D before buffering, so its
        # buffers need neither num_classes nor the multilabel specs
        if average == "micro":
            if multilabel and buffer_capacity is None:
                curve_buffer_specs(None, multilabel, None)  # raises: the flag needs a capacity
            self._init_sample_states(buffer_capacity, None, specs=None)
        else:
            self._init_sample_states(
                buffer_capacity, num_classes, specs=curve_buffer_specs(num_classes, multilabel, buffer_capacity)
            )

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target, num_classes, pos_label = _average_precision_update(
            preds, target, self.num_classes, self.pos_label, self.average
        )
        self._append_samples(preds, target)
        self.num_classes = num_classes
        self.pos_label = pos_label

    def compute(self) -> Union[List[torch.Tensor], torch.Tensor]:
        preds, target = self._collect_samples()
        if not self.num_classes:
            raise ValueError(f"`num_classes` bas to be positive number, but got {self.num_classes}")
        average = None if self.average == "none" else self.average
        return _average_precision_compute(preds, target, self.num_classes, self.pos_label, average)

"""PrecisionRecallCurve module metric (counterpart of
``metrics_tpu/classification/precision_recall_curve.py``): buffers the
samples (or a fixed ``buffer_capacity`` of them) and computes the exact curve."""
from typing import Any, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    _precision_recall_curve_compute,
    _precision_recall_curve_update,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.bounded import _BoundedSampleBufferMixin, curve_buffer_specs


class PrecisionRecallCurve(_BoundedSampleBufferMixin, Metric):
    """Precision-recall pairs at every distinct threshold.

    Args:
        num_classes: class count for multiclass score inputs.
        pos_label: positive-class label for binary inputs.
        buffer_capacity: fix the sample buffers to this many samples (exact,
            overflow checked); multiclass needs ``num_classes`` up front.
        multilabel: with ``buffer_capacity``, updates carry ``[N, num_classes]`` targets.
        device: see :class:`~metrics_tpu_torch.metric.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import PrecisionRecallCurve
        >>> prc = PrecisionRecallCurve(device="cpu")
        >>> prc.update(torch.tensor([0.1, 0.4, 0.6, 0.9]), torch.tensor([0, 0, 1, 1]))
        >>> precision, recall, thresholds = prc.compute()
        >>> print([round(float(v), 2) for v in precision], [round(float(v), 2) for v in recall])
        [1.0, 1.0, 1.0] [1.0, 0.5, 0.0]
    """

    is_differentiable = False
    higher_is_better = None
    _dynamic_state_attrs = ("num_classes", "pos_label")

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        buffer_capacity: Optional[int] = None,
        multilabel: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.pos_label = pos_label
        self._init_sample_states(
            buffer_capacity, num_classes, specs=curve_buffer_specs(num_classes, multilabel, buffer_capacity)
        )

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target, num_classes, pos_label = _precision_recall_curve_update(preds, target, self.num_classes, self.pos_label)
        self._append_samples(preds, target)
        self.num_classes = num_classes
        self.pos_label = pos_label

    def compute(self) -> Union[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]]:
        preds, target = self._collect_samples()
        if not self.num_classes:
            raise ValueError(f"`num_classes` bas to be positive number, but got {self.num_classes}")
        return _precision_recall_curve_compute(preds, target, self.num_classes, self.pos_label)

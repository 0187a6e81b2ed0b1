"""AUROC module metric (counterpart of ``metrics_tpu/classification/auroc.py``).

By default it buffers every prediction and target and computes the exact
area at ``compute``. Two constant-memory modes: ``buffer_capacity=N`` (exact
over a fixed window, overflow checked) and ``thresholds=T`` (binary only):
each update counts its batch against ``T`` thresholds in one launch of the
``binned_counts`` kernel into four ``[T]`` counters, and ``compute`` is the
trapezoidal area under the binned ROC curve, an approximation of the exact
rank statistic that sharpens with more thresholds.
"""
from typing import Any, Optional, Sequence, Union

import torch

from metrics_tpu_torch.functional.classification.auroc import _auroc_compute, _auroc_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops.binned_counts import binned_stat_counts
from metrics_tpu_torch.ops.safe_ops import safe_divide
from metrics_tpu_torch.utils.bounded import _BoundedSampleBufferMixin, curve_buffer_specs
from metrics_tpu_torch.utils.data import _linspace
from metrics_tpu_torch.utils.enums import DataType


class AUROC(_BoundedSampleBufferMixin, Metric):
    """Area under the ROC curve.

    Args:
        num_classes: number of classes for multiclass/multilabel inputs.
        pos_label: the label treated as positive in the binary case.
        average: ``macro``, ``weighted``, ``micro`` (multilabel only) or
            ``none``, over the per-class areas.
        max_fpr: restrict the area to [0, max_fpr] (binary only, McClish
            standardization).
        buffer_capacity: fix the sample buffers to this many samples (exact,
            overflow checked). Multiclass needs ``num_classes`` up front;
            multilabel also ``multilabel=True``.
        multilabel: with ``buffer_capacity``, updates carry ``[N, num_classes]``
            targets.
        thresholds: binary-only binned mode: an int ``T`` bins at ``T`` evenly
            spaced thresholds over [0, 1], a sequence or tensor is used as
            given (ascending). Excludes ``buffer_capacity`` and ``max_fpr``.
        device: see :class:`~metrics_tpu_torch.metric.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import AUROC
        >>> auroc = AUROC(device="cpu")
        >>> auroc.update(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))
        >>> print(round(float(auroc.compute()), 4))
        0.75
    """

    is_differentiable = False
    higher_is_better = True
    _dynamic_state_attrs = ("mode",)

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        average: Optional[str] = "macro",
        max_fpr: Optional[float] = None,
        buffer_capacity: Optional[int] = None,
        multilabel: bool = False,
        thresholds: Optional[Union[int, Sequence[float], torch.Tensor]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.pos_label = pos_label
        self.average = average
        self.max_fpr = max_fpr

        allowed_average = (None, "macro", "weighted", "micro")
        if average not in allowed_average:
            raise ValueError(f"Argument `average` expected to be one of the following: {allowed_average} but got {average}")
        if max_fpr is not None and (not isinstance(max_fpr, float) or not 0 < max_fpr <= 1):
            raise ValueError(f"`max_fpr` should be a float in range (0, 1], got: {max_fpr}")

        self.mode: Optional[DataType] = None
        if thresholds is not None:
            if buffer_capacity is not None or multilabel:
                raise ValueError(
                    "`thresholds` (streaming binned mode) and `buffer_capacity` are"
                    " mutually exclusive constant-memory modes — pick one"
                )
            if max_fpr is not None:
                raise ValueError("`max_fpr` is not supported in the binned `thresholds` mode")
            if isinstance(thresholds, int):
                if thresholds < 2:
                    raise ValueError(f"`thresholds` as an int must be >= 2, got {thresholds}")
                ths = _linspace(0.0, 1.0, thresholds, dtype=torch.float32, device=self.device)
            else:
                ths = torch.as_tensor(thresholds, dtype=torch.float32, device=self.device)
                if ths.ndim != 1 or ths.shape[0] < 2:
                    raise ValueError("`thresholds` must be a 1D sequence with at least 2 entries")
            self.register_buffer("thresholds", ths, persistent=False)  # ascending; compute reverses the sweep
            self.buffer_capacity = None
            for name in ("bTPs", "bFPs", "bFNs", "bTNs"):
                self.add_state(name, torch.zeros(ths.shape[0], dtype=torch.int64), dist_reduce_fx="sum")
        else:
            self.thresholds = None
            self._init_sample_states(
                buffer_capacity, num_classes, specs=curve_buffer_specs(num_classes, multilabel, buffer_capacity)
            )

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target, mode = _auroc_update(preds, target)
        if self.thresholds is not None:
            if mode != DataType.BINARY:
                raise ValueError(f"The binned `thresholds` mode of AUROC only supports binary data, got mode {mode}")
            tps, fps, fns, tns = binned_stat_counts(
                preds.reshape(-1, 1), (target == 1).to(torch.int32).reshape(-1, 1), self.thresholds
            )
            self.bTPs = self.bTPs + tps[0]
            self.bFPs = self.bFPs + fps[0]
            self.bFNs = self.bFNs + fns[0]
            self.bTNs = self.bTNs + tns[0]
        else:
            self._append_samples(preds, target)
        if self.mode and self.mode != mode:
            raise ValueError(
                "The mode of data (binary, multi-label, multi-class) should be constant, but changed"
                f" between batches from {self.mode} to {mode}"
            )
        self.mode = mode

    def compute(self) -> torch.Tensor:
        if not self.mode:
            raise RuntimeError("You have to have determined mode.")
        if self.thresholds is not None:
            tpr = safe_divide(self.bTPs.to(torch.float32), (self.bTPs + self.bFNs).to(torch.float32))
            fpr = safe_divide(self.bFPs.to(torch.float32), (self.bFPs + self.bTNs).to(torch.float32))
            # ascending thresholds sweep the curve backwards: reverse it and pin
            # the (0, 0) and (1, 1) ends; the trapezoids are summed in float64
            ends = torch.zeros(1, dtype=torch.float64, device=tpr.device), torch.ones(1, dtype=torch.float64, device=tpr.device)
            tpr = torch.cat([ends[0], tpr.flip(0), ends[1]])
            fpr = torch.cat([ends[0], fpr.flip(0), ends[1]])
            return torch.sum((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2.0)
        preds, target = self._collect_samples()
        return _auroc_compute(preds, target, self.mode, self.num_classes, self.pos_label, self.average, self.max_fpr)

"""MatchErrorRate module metric (counterpart of ``metrics_tpu/text/mer.py``)."""
from typing import Any, List, Union

import torch

from metrics_tpu_torch.functional.text.helper import _on_device
from metrics_tpu_torch.functional.text.mer import _mer_compute, _mer_update
from metrics_tpu_torch.metric import Metric


class MatchErrorRate(Metric):
    """Streaming match error rate over transcript batches.

    The string work runs on the host; the counters are float32 ``"sum"``
    states on the metric's device, exact up to 2^24 per counter, and an
    update copies them to the device once.

    Example:
        >>> from metrics_tpu_torch import MatchErrorRate
        >>> metric = MatchErrorRate(device="cpu")
        >>> print(round(float(metric(['hello world'], ['hello there world'])), 4))
        0.3333
    """

    is_differentiable = False
    higher_is_better = False

    def __init__(self, **kwargs: Any) -> None:
        kwargs.setdefault("jit_update", False)  # string inputs never run as a program
        super().__init__(**kwargs)
        self.add_state("errors", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        errors, total = _on_device(_mer_update(preds, target), self.device).unbind()
        self.errors = self.errors + errors
        self.total = self.total + total

    def compute(self) -> torch.Tensor:
        return _mer_compute(self.errors, self.total)

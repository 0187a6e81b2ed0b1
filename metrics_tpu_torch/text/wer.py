"""WordErrorRate module metric (counterpart of ``metrics_tpu/text/wer.py``)."""
from typing import Any, List, Union

import torch

from metrics_tpu_torch.functional.text.helper import _on_device
from metrics_tpu_torch.functional.text.wer import _wer_compute, _wer_update
from metrics_tpu_torch.metric import Metric


class WordErrorRate(Metric):
    """Streaming word error rate: total edit distance over total reference words; lower is better.

    The string work runs on the host; the counters are float32 ``"sum"``
    states on the metric's device, exact up to 2^24 per counter, and an
    update copies them to the device once.

    Example:
        >>> from metrics_tpu_torch import WordErrorRate
        >>> metric = WordErrorRate(device="cpu")
        >>> print(round(float(metric(['this is the prediction', 'there is an other sample'], ['this is the reference', 'there is another one'])), 4))
        0.5
    """

    is_differentiable = False
    higher_is_better = False

    def __init__(self, **kwargs: Any) -> None:
        kwargs.setdefault("jit_update", False)  # string inputs never run as a program
        super().__init__(**kwargs)
        self.add_state("errors", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        errors, total = _on_device(_wer_update(preds, target), self.device).unbind()
        self.errors = self.errors + errors
        self.total = self.total + total

    def compute(self) -> torch.Tensor:
        return _wer_compute(self.errors, self.total)

"""WordInfoLost module metric (counterpart of ``metrics_tpu/text/wil.py``)."""
from typing import Any, List, Union

import torch

from metrics_tpu_torch.functional.text.helper import _on_device
from metrics_tpu_torch.functional.text.wil import _wil_compute, _wil_update
from metrics_tpu_torch.metric import Metric


class WordInfoLost(Metric):
    """Streaming word information lost over transcript batches.

    The string work runs on the host; the counters are float32 ``"sum"``
    states on the metric's device, exact up to 2^24 per counter, and an
    update copies them to the device once.

    Example:
        >>> from metrics_tpu_torch import WordInfoLost
        >>> metric = WordInfoLost(device="cpu")
        >>> print(round(float(metric(['hello world'], ['hello there world'])), 4))
        0.3333
    """

    is_differentiable = False
    higher_is_better = False

    def __init__(self, **kwargs: Any) -> None:
        kwargs.setdefault("jit_update", False)  # string inputs never run as a program
        super().__init__(**kwargs)
        self.add_state("hits", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("target_total", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("preds_total", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        hits, target_total, preds_total = _on_device(_wil_update(preds, target), self.device).unbind()
        self.hits = self.hits + hits
        self.target_total = self.target_total + target_total
        self.preds_total = self.preds_total + preds_total

    def compute(self) -> torch.Tensor:
        return _wil_compute(self.hits, self.target_total, self.preds_total)

"""SQuAD module metric (counterpart of ``metrics_tpu/text/squad.py``)."""
from typing import Any, Dict

import torch

from metrics_tpu_torch.functional.text.squad import (
    PREDS_TYPE,
    TARGETS_TYPE,
    _squad_compute,
    _squad_input_check,
    _squad_on_device,
    _squad_update,
)
from metrics_tpu_torch.metric import Metric


class SQuAD(Metric):
    """Streaming SQuAD exact match and F1 over question-answering batches:
    the F1 and exact-match sums are float32 ``"sum"`` states, exact up to
    2^24, and the question count an int64 one; an update copies all three
    to the device once.

    Example:
        >>> from metrics_tpu_torch import SQuAD
        >>> squad = SQuAD(device="cpu")
        >>> preds = [{'prediction_text': '1976', 'id': '56e10a3be3433e1400422b22'}]
        >>> target = [{'answers': {'answer_start': [97], 'text': ['1976']}, 'id': '56e10a3be3433e1400422b22'}]
        >>> out = squad(preds, target)
        >>> print(round(float(out['exact_match']), 1), round(float(out['f1']), 1))
        100.0 100.0
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(self, **kwargs: Any) -> None:
        kwargs.setdefault("jit_update", False)  # string inputs never run as a program
        super().__init__(**kwargs)
        self.add_state("f1_score", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("exact_match", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")

    def update(self, preds: PREDS_TYPE, target: TARGETS_TYPE) -> None:
        preds_dict, target_dict = _squad_input_check(preds, target)
        f1, exact_match, total = _squad_on_device(*_squad_update(preds_dict, target_dict), self.device)
        self.f1_score = self.f1_score + f1
        self.exact_match = self.exact_match + exact_match
        self.total = self.total + total

    def compute(self) -> Dict[str, torch.Tensor]:
        return _squad_compute(self.f1_score, self.exact_match, self.total)

"""The numbers ``correct`` compares, each against its limit.

* ``counts_off``: confusion-count cells of the program's outputs and states
  that differ from the reference's, summed over everything compared. An
  exact comparison: its limit is 0.
* ``score_gap``: the largest absolute gap between a score the program
  returned (accuracy, macro F1, IoU) and the reference's, in float64.
* ``missing``: outputs that never came, or came with another shape.
"""
import math
from typing import Dict

import torch


class Gaps:
    def __init__(self) -> None:
        self.counts_off = 0
        self.score_gap = 0.0
        self.missing = 0
        self.compared = 0

    def counts(self, got, want: torch.Tensor) -> None:
        self.compared += 1
        if got is None or tuple(got.shape) != tuple(want.shape):
            self.missing += 1
            self.counts_off += want.numel()
            return
        self.counts_off += int((got.to(want.device, torch.int64) != want).sum())

    def score(self, got, want: torch.Tensor) -> None:
        self.compared += 1
        if got is None or tuple(got.shape) != tuple(want.shape):
            self.missing += 1
            self.score_gap = math.inf
            return
        gap = (got.to(want.device, torch.float64) - want).abs()
        worst = float(gap.max()) if gap.numel() else 0.0
        if math.isnan(worst) or not bool(torch.isfinite(got).all()):
            worst = math.inf
        self.score_gap = max(self.score_gap, worst)

    def value(self, got, want: torch.Tensor) -> None:
        """A member's value: counts where the reference gives counts, else a score."""
        if want.dtype == torch.int64:
            self.counts(got, want)
        else:
            self.score(got, want)

    def numbers(self) -> Dict[str, float]:
        return {"counts_off": self.counts_off, "score_gap": self.score_gap, "missing": self.missing}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit; a number without a limit fails."""
    return all(name in limits and numbers[name] <= limits[name] for name in numbers)

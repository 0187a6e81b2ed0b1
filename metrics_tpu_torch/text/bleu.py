"""BLEUScore module metric (counterpart of ``metrics_tpu/text/bleu.py``)."""
from typing import Any, Sequence

import torch

from metrics_tpu_torch.functional.text.bleu import (
    _bleu_score_compute,
    _bleu_score_update,
    _bleu_stats,
    _split_stats,
    _tokenize_fn,
)
from metrics_tpu_torch.functional.text.helper import _on_device
from metrics_tpu_torch.metric import Metric


class BLEUScore(Metric):
    """Streaming corpus-level BLEU.

    N-grams are counted on the host; ``preds_len``, ``target_len``,
    ``numerator`` and ``denominator`` are float32 ``"sum"`` states on the
    metric's device, exact up to 2^24 per counter, and an update copies them
    to the device once.

    Args:
        n_gram: largest n-gram order scored (default 4).
        smooth: add-one smoothing of the n-gram precisions past the first.

    Example:
        >>> from metrics_tpu_torch import BLEUScore
        >>> bleu = BLEUScore(device="cpu")
        >>> score = bleu(['the quick brown fox jumps high'], [['the quick brown fox leaps high']])
        >>> print(round(float(score), 4))
        0.5373
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(self, n_gram: int = 4, smooth: bool = False, **kwargs: Any) -> None:
        kwargs.setdefault("jit_update", False)  # string inputs never run as a program
        super().__init__(**kwargs)
        self.n_gram = n_gram
        self.smooth = smooth
        self.tokenizer = _tokenize_fn
        self.add_state("preds_len", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("target_len", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("numerator", default=torch.zeros(n_gram, dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("denominator", default=torch.zeros(n_gram, dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, preds: Sequence[str], target: Sequence[Sequence[str]]) -> None:
        preds_ = [preds] if isinstance(preds, str) else list(preds)
        target_ = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]
        if len(preds_) != len(target_):
            raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
        counts = _bleu_score_update(preds_, target_, self.n_gram, self.tokenizer)
        preds_len, target_len, numerator, denominator = _split_stats(_on_device(_bleu_stats(*counts), self.device), self.n_gram)
        self.preds_len = self.preds_len + preds_len
        self.target_len = self.target_len + target_len
        self.numerator = self.numerator + numerator
        self.denominator = self.denominator + denominator

    def compute(self) -> torch.Tensor:
        return _bleu_score_compute(self.preds_len, self.target_len, self.numerator, self.denominator, self.n_gram, self.smooth)

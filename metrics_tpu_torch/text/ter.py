"""TranslationEditRate module metric (counterpart of ``metrics_tpu/text/ter.py``)."""
from typing import Any, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.functional.text.helper import _on_device
from metrics_tpu_torch.functional.text.ter import _TercomTokenizer, _ter_compute, _ter_update
from metrics_tpu_torch.metric import Metric


class TranslationEditRate(Metric):
    """Streaming corpus-level TER: the edit and reference-length counters are
    float32 ``"sum"`` states on the metric's device, exact up to 2^24 per
    counter; with ``return_sentence_level_score`` the per-sentence scores are
    a ``"cat"`` list state. An update copies its numbers to the device once.

    Example:
        >>> from metrics_tpu_torch import TranslationEditRate
        >>> ter = TranslationEditRate(device="cpu")
        >>> print(round(float(ter(['the cat sat on the mat'], [['the fat cat sat on a mat']])), 4))
        0.2857
    """

    is_differentiable = False
    higher_is_better = False

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("jit_update", False)  # string inputs never run as a program
        super().__init__(**kwargs)
        for name, value in (
            ("normalize", normalize),
            ("no_punctuation", no_punctuation),
            ("lowercase", lowercase),
            ("asian_support", asian_support),
        ):
            if not isinstance(value, bool):
                raise ValueError(f"Expected argument `{name}` to be a boolean.")
        self.tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
        self.return_sentence_level_score = return_sentence_level_score
        self.add_state("total_num_edits", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total_tgt_len", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        if self.return_sentence_level_score:
            self.add_state("sentence_ter", default=[], dist_reduce_fx="cat", placeholder=torch.float32)

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        num_edits, tgt_length, sentence_scores = _ter_update(preds, target, self.tokenizer)
        stats = _on_device(np.concatenate([[num_edits, tgt_length], sentence_scores]), self.device)
        self.total_num_edits = self.total_num_edits + stats[0]
        self.total_tgt_len = self.total_tgt_len + stats[1]
        if self.return_sentence_level_score:
            self.sentence_ter.append(stats[2:])

    def compute(self) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        corpus = _ter_compute(self.total_num_edits, self.total_tgt_len)
        if self.return_sentence_level_score:
            return corpus, self.cat_state("sentence_ter")
        return corpus

"""CHRFScore module metric (counterpart of ``metrics_tpu/text/chrf.py``)."""
from typing import Any, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.functional.text.chrf import _check_chrf_args, _chrf_score_compute, _chrf_score_update
from metrics_tpu_torch.functional.text.helper import _on_device
from metrics_tpu_torch.metric import Metric

_ROLES = ("preds", "target", "matching")


class CHRFScore(Metric):
    """Streaming corpus-level chrF or chrF++.

    Each role (preds, target, matching) keeps one float32 ``[order]`` count
    vector per kind (char, word), a ``"sum"`` state exact up to 2^24 per
    counter; an update copies all six to the device once. With
    ``return_sentence_level_score`` the per-sentence scores are a ``"cat"``
    list state, one float32 vector per update.

    Example:
        >>> from metrics_tpu_torch import CHRFScore
        >>> chrf = CHRFScore(device="cpu")
        >>> print(round(float(chrf(['the cat sat'], [['the fat cat sat']])), 4))
        0.4906
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(
        self,
        n_char_order: int = 6,
        n_word_order: int = 2,
        beta: float = 2.0,
        lowercase: bool = False,
        whitespace: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("jit_update", False)  # string inputs never run as a program
        super().__init__(**kwargs)
        _check_chrf_args(n_char_order, n_word_order, beta)
        self.n_char_order = n_char_order
        self.n_word_order = n_word_order
        self.beta = beta
        self.lowercase = lowercase
        self.whitespace = whitespace
        self.return_sentence_level_score = return_sentence_level_score
        self.n_order = float(n_char_order + n_word_order)
        for role in _ROLES:
            for kind, order in (("char", n_char_order), ("word", n_word_order)):
                self.add_state(f"total_{role}_{kind}_n_grams", default=torch.zeros(order, dtype=torch.float32), dist_reduce_fx="sum")
        if self.return_sentence_level_score:
            self.add_state("sentence_chrf_score", default=[], dist_reduce_fx="cat", placeholder=torch.float32)

    def update(self, preds: Sequence[str], target: Sequence[Sequence[str]]) -> None:
        *counts, sentence_scores = _chrf_score_update(
            preds, target, self.n_char_order, self.n_word_order, self.beta, self.lowercase, self.whitespace
        )
        stats = _on_device(np.concatenate([*counts, sentence_scores]), self.device)
        sizes = [c.size for c in counts] + [len(sentence_scores)]
        parts = torch.split(stats, sizes)
        names = [f"total_{role}_{kind}_n_grams" for role in _ROLES for kind in ("char", "word")]
        for name, delta in zip(names, parts):
            setattr(self, name, getattr(self, name) + delta)
        if self.return_sentence_level_score:
            self.sentence_chrf_score.append(parts[-1])

    def compute(self) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        corpus = _chrf_score_compute(
            self.total_preds_char_n_grams,
            self.total_preds_word_n_grams,
            self.total_target_char_n_grams,
            self.total_target_word_n_grams,
            self.total_matching_char_n_grams,
            self.total_matching_word_n_grams,
            self.n_order,
            self.beta,
        )
        if self.return_sentence_level_score:
            return corpus, self.cat_state("sentence_chrf_score")
        return corpus

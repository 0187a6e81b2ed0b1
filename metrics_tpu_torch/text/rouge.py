"""ROUGEScore module metric (counterpart of ``metrics_tpu/text/rouge.py``)."""
from typing import Any, Dict, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.text.rouge import (
    ROUGE_STATS,
    _check_rouge_args,
    _normalize_rouge_inputs,
    _porter_stemmer,
    _rouge_rows,
    _rouge_score_compute,
    _rouge_score_update,
)
from metrics_tpu_torch.metric import Metric


class ROUGEScore(Metric):
    """Streaming ROUGE with one list state per ``<key>_<stat>`` pair, each a
    list of float32 0-d tensors (one per sentence) on the metric's device, as
    in the JAX package (``dist_reduce_fx=None``: a sync stacks the ranks').
    An update builds all its sentences' rows on the host, copies them to the
    device once and appends views of that copy.

    Example:
        >>> from metrics_tpu_torch import ROUGEScore
        >>> rouge = ROUGEScore(device="cpu")
        >>> scores = rouge(['My name is John'], ['Is your name John'])
        >>> print(round(float(scores['rouge1_fmeasure']), 4))
        0.75
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(
        self,
        use_stemmer: bool = False,
        accumulate: str = "best",
        rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("jit_update", False)  # string inputs never run as a program
        super().__init__(**kwargs)
        self.rouge_keys, self.rouge_keys_values = _check_rouge_args(rouge_keys, accumulate, use_stemmer)
        self.accumulate = accumulate
        self.use_stemmer = use_stemmer
        self._stemmer = _porter_stemmer() if use_stemmer else None
        for key in self.rouge_keys:
            for stat in ROUGE_STATS:
                self.add_state(f"{key}_{stat}", default=[], dist_reduce_fx=None, placeholder=torch.float32)

    def update(
        self,
        preds: Union[str, Sequence[str]],
        target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    ) -> None:
        preds, target = _normalize_rouge_inputs(preds, target)
        results = _rouge_score_update(preds, target, self.rouge_keys_values, self.accumulate, self._stemmer)
        rows = torch.as_tensor(_rouge_rows(results, self.rouge_keys_values), dtype=torch.float32).to(self.device)
        names = [f"{key}_{stat}" for key in self.rouge_keys for stat in ROUGE_STATS]
        for name, row in zip(names, rows):
            getattr(self, name).extend(row.unbind())

    def compute(self) -> Dict[str, torch.Tensor]:
        return _rouge_score_compute(
            {f"{key}_{stat}": self.cat_state(f"{key}_{stat}") for key in self.rouge_keys for stat in ROUGE_STATS}
        )

    def __getstate__(self) -> Dict[str, Any]:
        state = super().__getstate__()
        state.pop("_stemmer", None)  # rebuilt on load: nltk's stemmer caches are not worth pickling
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        super().__setstate__(state)
        self._stemmer = _porter_stemmer() if self.use_stemmer else None

"""ExtendedEditDistance module metric (counterpart of ``metrics_tpu/text/eed.py``)."""
from typing import Any, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.functional.text.eed import _check_eed_args, _eed_compute, _eed_update
from metrics_tpu_torch.functional.text.helper import _on_device
from metrics_tpu_torch.metric import Metric


class ExtendedEditDistance(Metric):
    """Streaming EED: the per-sentence scores are a ``"cat"`` list state,
    one float32 vector on the metric's device per update, and ``compute``
    is their mean.

    Example:
        >>> from metrics_tpu_torch import ExtendedEditDistance
        >>> eed = ExtendedEditDistance(device="cpu")
        >>> print(round(float(eed(['this is a prediction'], [['this is a reference']])), 4))
        0.4146
    """

    is_differentiable = False
    higher_is_better = False

    def __init__(
        self,
        language: str = "en",
        return_sentence_level_score: bool = False,
        alpha: float = 2.0,
        rho: float = 0.3,
        deletion: float = 0.2,
        insertion: float = 1.0,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("jit_update", False)  # string inputs never run as a program
        super().__init__(**kwargs)
        if language not in ("en", "ja"):
            raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
        _check_eed_args(alpha, rho, deletion, insertion)
        self.language = language
        self.return_sentence_level_score = return_sentence_level_score
        self.alpha = alpha
        self.rho = rho
        self.deletion = deletion
        self.insertion = insertion
        self.add_state("sentence_eed", default=[], dist_reduce_fx="cat", placeholder=torch.float32)

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]) -> None:
        scores = _eed_update(preds, target, self.language, self.alpha, self.rho, self.deletion, self.insertion)
        if scores:
            self.sentence_eed.append(_on_device(scores, self.device))

    def compute(self) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        scores = self.cat_state("sentence_eed")
        average = _eed_compute(scores)
        if self.return_sentence_level_score:
            return average, scores
        return average

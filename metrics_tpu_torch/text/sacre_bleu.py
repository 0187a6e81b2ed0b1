"""SacreBLEUScore module metric (counterpart of ``metrics_tpu/text/sacre_bleu.py``)."""
from typing import Any

from metrics_tpu_torch.functional.text.sacre_bleu import _SacreBLEUTokenizer
from metrics_tpu_torch.text.bleu import BLEUScore


class SacreBLEUScore(BLEUScore):
    """Streaming corpus-level SacreBLEU: BLEU with canonical tokenization
    (``tokenize`` one of ``none``, ``13a``, ``zh``, ``intl`` (needs
    ``regex``) and ``char``).

    Example:
        >>> from metrics_tpu_torch import SacreBLEUScore
        >>> sacre = SacreBLEUScore(device="cpu")
        >>> print(round(float(sacre(['the quick brown fox jumps high'], [['the quick brown fox leaps high']])), 4))
        0.5373
    """

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        tokenize: str = "13a",
        lowercase: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(n_gram=n_gram, smooth=smooth, **kwargs)
        self.tokenizer = _SacreBLEUTokenizer(tokenize, lowercase)

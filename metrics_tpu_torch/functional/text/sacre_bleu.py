"""SacreBLEU (counterpart of ``metrics_tpu/functional/text/sacre_bleu.py``).

BLEU with the canonical sacrebleu tokenizers (``none``/``13a``/``zh``/
``intl``/``char``), re-implemented from the published sacrebleu tokenizer
spec (Post 2018). The ``intl`` tokenizer needs unicode-property regexes and
is gated on the optional ``regex`` package, imported when it is first used.
"""
import functools
import importlib.util
import re
from typing import Any, Optional, Sequence, Tuple

import torch

from metrics_tpu_torch.functional.text.bleu import _bleu_score_compute, _bleu_score_update, _bleu_stats, _split_stats
from metrics_tpu_torch.functional.text.helper import _on_device
from metrics_tpu_torch.metric import resolve_device

AVAILABLE_TOKENIZERS = ("none", "13a", "zh", "intl", "char")

# CJK codepoint ranges that the ``zh`` tokenizer isolates into single tokens
_CJK_RANGES = (
    (0x3400, 0x4DB5),
    (0x4E00, 0x9FA5),
    (0x9FA6, 0x9FBB),
    (0xF900, 0xFA2D),
    (0xFA30, 0xFA6A),
    (0xFA70, 0xFAD9),
    (0x20000, 0x2A6D6),
    (0x2F800, 0x2FA1D),
    (0xFF00, 0xFFEF),
    (0x2E80, 0x2EFF),
    (0x3000, 0x303F),
    (0x31C0, 0x31EF),
    (0x2F00, 0x2FDF),
    (0x2FF0, 0x2FFF),
    (0x3100, 0x312F),
    (0x31A0, 0x31BF),
    (0xFE10, 0xFE1F),
    (0xFE30, 0xFE4F),
    (0x2600, 0x26FF),
    (0x2700, 0x27BF),
    (0x3200, 0x32FF),
    (0x3300, 0x33FF),
)

# mteval-v13a language-independent tokenization rules
_13A_REGEX = (
    (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
    (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
    (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
    (re.compile(r"([0-9])(-)"), r"\1 \2 "),
)


def _regex_available() -> bool:
    return importlib.util.find_spec("regex") is not None


@functools.lru_cache(maxsize=1)
def _intl_regex() -> Tuple[Tuple[Any, str], ...]:
    import regex

    return (
        (regex.compile(r"(\P{N})(\p{P})"), r"\1 \2 "),
        (regex.compile(r"(\p{P})(\P{N})"), r" \1 \2"),
        (regex.compile(r"(\p{S})"), r" \1 "),
    )


class _SacreBLEUTokenizer:
    """String to token-list tokenizer matching sacrebleu's reference set."""

    def __init__(self, tokenize: str = "13a", lowercase: bool = False) -> None:
        if tokenize not in AVAILABLE_TOKENIZERS:
            raise ValueError(f"Unsupported tokenizer {tokenize!r}; pick from {AVAILABLE_TOKENIZERS}")
        if tokenize == "intl" and not _regex_available():
            raise ModuleNotFoundError(
                "The `intl` tokenizer requires the `regex` package (unicode property support)."
            )
        self._tokenize = tokenize
        self.lowercase = lowercase

    def __call__(self, line: str) -> Sequence[str]:
        tokenized = getattr(self, f"_tokenize_{self._tokenize}")(line)
        if self.lowercase:
            tokenized = tokenized.lower()
        return tokenized.split()

    @staticmethod
    def _tokenize_none(line: str) -> str:
        return line

    @staticmethod
    def _apply_regex(line: str, rules) -> str:
        for pattern, replacement in rules:
            line = pattern.sub(replacement, line)
        return " ".join(line.split())

    @classmethod
    def _tokenize_13a(cls, line: str) -> str:
        line = line.replace("<skipped>", "")
        line = line.replace("-\n", "")
        line = line.replace("\n", " ")
        if "&" in line:
            line = line.replace("&quot;", '"')
            line = line.replace("&amp;", "&")
            line = line.replace("&lt;", "<")
            line = line.replace("&gt;", ">")
        return cls._apply_regex(f" {line} ", _13A_REGEX)

    @classmethod
    def _tokenize_zh(cls, line: str) -> str:
        line = line.strip()
        spaced = []
        for ch in line:
            cp = ord(ch)
            if any(lo <= cp <= hi for lo, hi in _CJK_RANGES):
                spaced.append(f" {ch} ")
            else:
                spaced.append(ch)
        return cls._apply_regex("".join(spaced), _13A_REGEX)

    @classmethod
    def _tokenize_intl(cls, line: str) -> str:
        return cls._apply_regex(line, _intl_regex())

    @staticmethod
    def _tokenize_char(line: str) -> str:
        return " ".join(ch for ch in line)


def sacre_bleu_score(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int = 4,
    smooth: bool = False,
    tokenize: str = "13a",
    lowercase: bool = False,
    device: Optional[Any] = None,
) -> torch.Tensor:
    """SacreBLEU: BLEU with canonical tokenization for reproducible scores.

    Example:
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> round(float(sacre_bleu_score(preds, target, device="cpu")), 4)
        0.7598
    """
    if len(preds) != len(target):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")
    tokenizer = _SacreBLEUTokenizer(tokenize, lowercase)
    counts = _bleu_score_update(list(preds), [list(t) for t in target], n_gram, tokenizer)
    stats = _on_device(_bleu_stats(*counts), resolve_device(device))
    preds_len, target_len, numerator, denominator = _split_stats(stats, n_gram)
    return _bleu_score_compute(preds_len, target_len, numerator, denominator, n_gram, smooth)

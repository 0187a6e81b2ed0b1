"""chrF / chrF++ score (counterpart of ``metrics_tpu/functional/text/chrf.py``).

Popović 2015 (chrF) and 2017 (chrF++): character and word n-gram F-beta
scores; with several references, the one with the best sentence-level F
carries the target and matching counts. Counting runs on the host; the six
per-order count vectors are float32 tensors on the metric's device, one
``[n_order]`` vector per role as in the JAX package, exact up to 2^24 per
counter.
"""
import string
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.metric import resolve_device

_EPS_SMOOTHING = 1e-16
_PUNCTUATION = set(string.punctuation)


def _get_characters(sentence: str, whitespace: bool) -> List[str]:
    if whitespace:
        return list(sentence)
    return list(sentence.strip().replace(" ", ""))


def _separate_word_and_punctuation(word: str) -> List[str]:
    """Split a single leading or trailing punctuation mark off a word."""
    if len(word) == 1:
        return [word]
    if word[-1] in _PUNCTUATION:
        return [word[:-1], word[-1]]
    if word[0] in _PUNCTUATION:
        return [word[0], word[1:]]
    return [word]


def _get_words_and_punctuation(sentence: str) -> List[str]:
    return sum((_separate_word_and_punctuation(w) for w in sentence.strip().split()), [])


def _ngram_counts(tokens: List[str], n_gram_order: int) -> Dict[int, Counter]:
    out: Dict[int, Counter] = {}
    for n in range(1, n_gram_order + 1):
        counter: Counter = Counter()
        for i in range(len(tokens) - n + 1):
            counter[tuple(tokens[i : i + n])] += 1
        out[n] = counter
    return out


def _sentence_counts(
    sentence: str, n_char_order: int, n_word_order: int, lowercase: bool, whitespace: bool
) -> Tuple[Dict[int, Counter], Dict[int, Counter], np.ndarray, np.ndarray]:
    """Character and word n-gram multisets and their per-order totals for one sentence."""
    if lowercase:
        sentence = sentence.lower()
    char_counts = _ngram_counts(_get_characters(sentence, whitespace), n_char_order)
    word_counts = _ngram_counts(_get_words_and_punctuation(sentence), n_word_order)
    char_totals = np.array([sum(char_counts[n].values()) for n in range(1, n_char_order + 1)], dtype=np.float64)
    word_totals = np.array([sum(word_counts[n].values()) for n in range(1, n_word_order + 1)], dtype=np.float64)
    return char_counts, word_counts, char_totals, word_totals


def _matches(hyp_counts: Dict[int, Counter], ref_counts: Dict[int, Counter]) -> np.ndarray:
    orders = sorted(hyp_counts)
    return np.array(
        [sum(min(cnt, ref_counts[n][ng]) for ng, cnt in hyp_counts[n].items()) for n in orders],
        dtype=np.float64,
    )


def _fscore_from_counts(
    matching_char: np.ndarray,
    matching_word: np.ndarray,
    hyp_char: np.ndarray,
    hyp_word: np.ndarray,
    ref_char: np.ndarray,
    ref_word: np.ndarray,
    n_order: float,
    beta: float,
) -> float:
    """F-beta averaged over all character and word orders (sentence or corpus level)."""

    def _orders_fscore(matching: np.ndarray, ref: np.ndarray, hyp: np.ndarray) -> np.ndarray:
        # denominators guarded with 1: a masked 0/0 would warn
        precision = np.where(hyp > 0, matching / np.where(hyp > 0, hyp, 1.0), 0.0)
        recall = np.where(ref > 0, matching / np.where(ref > 0, ref, 1.0), 0.0)
        denominator = np.maximum(beta**2 * precision + recall, _EPS_SMOOTHING)
        return (1 + beta**2) * precision * recall / denominator

    char_f = _orders_fscore(matching_char, ref_char, hyp_char)
    word_f = _orders_fscore(matching_word, ref_word, hyp_word)
    return float((char_f.sum() + word_f.sum()) / n_order)


def _chrf_score_update(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    n_char_order: int,
    n_word_order: int,
    beta: float,
    lowercase: bool,
    whitespace: bool,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, List[float]]:
    """A batch's host count deltas ``(preds_char, preds_word, target_char,
    target_word, matching_char, matching_word, sentence_scores)``; the
    best-matching reference (highest sentence F) gives the target and
    matching counts."""
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, (list, tuple)) and all(isinstance(t, str) for t in target):
        target = [[t] for t in target]
    if len(preds) != len(target):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")

    n_order = float(n_char_order + n_word_order)
    total_preds_char = np.zeros(n_char_order)
    total_preds_word = np.zeros(n_word_order)
    total_target_char = np.zeros(n_char_order)
    total_target_word = np.zeros(n_word_order)
    total_matching_char = np.zeros(n_char_order)
    total_matching_word = np.zeros(n_word_order)
    sentence_scores: List[float] = []

    for pred, refs in zip(preds, target):
        hyp_char_counts, hyp_word_counts, hyp_char, hyp_word = _sentence_counts(
            pred, n_char_order, n_word_order, lowercase, whitespace
        )
        best_f = 0.0
        best_matching_char = np.zeros(n_char_order)
        best_matching_word = np.zeros(n_word_order)
        best_target_char = np.zeros(n_char_order)
        best_target_word = np.zeros(n_word_order)
        for ref in refs:
            ref_char_counts, ref_word_counts, ref_char, ref_word = _sentence_counts(
                ref, n_char_order, n_word_order, lowercase, whitespace
            )
            matching_char = _matches(hyp_char_counts, ref_char_counts)
            matching_word = _matches(hyp_word_counts, ref_word_counts)
            f_score = _fscore_from_counts(
                matching_char, matching_word, hyp_char, hyp_word, ref_char, ref_word, n_order, beta
            )
            if f_score > best_f:
                best_f = f_score
                best_matching_char, best_matching_word = matching_char, matching_word
                best_target_char, best_target_word = ref_char, ref_word

        total_preds_char += hyp_char
        total_preds_word += hyp_word
        total_target_char += best_target_char
        total_target_word += best_target_word
        total_matching_char += best_matching_char
        total_matching_word += best_matching_word
        sentence_scores.append(best_f)

    return (
        total_preds_char,
        total_preds_word,
        total_target_char,
        total_target_word,
        total_matching_char,
        total_matching_word,
        sentence_scores,
    )


def _chrf_score_compute(
    total_preds_char: torch.Tensor,
    total_preds_word: torch.Tensor,
    total_target_char: torch.Tensor,
    total_target_word: torch.Tensor,
    total_matching_char: torch.Tensor,
    total_matching_word: torch.Tensor,
    n_order: float,
    beta: float,
) -> torch.Tensor:
    """The corpus F-beta from the six count vectors: read to the host in one
    copy and scored in float64, as the JAX package does; a float32 tensor on
    the counts' device."""
    counts = (total_preds_char, total_preds_word, total_target_char, total_target_word, total_matching_char, total_matching_word)
    host = torch.cat([c.reshape(-1) for c in counts]).cpu().numpy().astype(np.float64)
    pc, pw, tc, tw, mc, mw = np.split(host, np.cumsum([c.numel() for c in counts])[:-1])
    score = _fscore_from_counts(mc, mw, pc, pw, tc, tw, n_order, beta)
    return torch.tensor(score, dtype=torch.float32, device=total_preds_char.device)


def _check_chrf_args(n_char_order: int, n_word_order: int, beta: float) -> None:
    if not isinstance(n_char_order, int) or n_char_order < 1:
        raise ValueError("Expected argument `n_char_order` to be an integer greater than or equal to 1.")
    if not isinstance(n_word_order, int) or n_word_order < 0:
        raise ValueError("Expected argument `n_word_order` to be an integer greater than or equal to 0.")
    if beta < 0:
        raise ValueError("Expected argument `beta` to be greater than 0.")


def chrf_score(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    n_char_order: int = 6,
    n_word_order: int = 2,
    beta: float = 2.0,
    lowercase: bool = False,
    whitespace: bool = False,
    return_sentence_level_score: bool = False,
    device: Optional[Any] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """chrF (``n_word_order=0``) or chrF++ (the default) machine-translation
    score, float32 on ``device`` (the GPU unless given).

    Example:
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat']]
        >>> round(float(chrf_score(preds, target, device="cpu")), 4)
        0.4942
    """
    _check_chrf_args(n_char_order, n_word_order, beta)
    dev = resolve_device(device)
    n_order = float(n_char_order + n_word_order)
    pc, pw, tc, tw, mc, mw, sentence_scores = _chrf_score_update(
        preds, target, n_char_order, n_word_order, beta, lowercase, whitespace
    )
    corpus = torch.tensor(_fscore_from_counts(mc, mw, pc, pw, tc, tw, n_order, beta), dtype=torch.float32, device=dev)
    if return_sentence_level_score:
        return corpus, torch.tensor(sentence_scores, dtype=torch.float32, device=dev)
    return corpus

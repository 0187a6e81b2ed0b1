"""BLEU score (counterpart of ``metrics_tpu/functional/text/bleu.py``).

N-gram counting runs on the host (the inputs are Python strings); the
counters ``preds_len``, ``target_len``, ``numerator`` and ``denominator``
are float32 tensors on the metric's device, exact up to 2^24 per counter.
"""
from collections import Counter
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.functional.text.helper import _on_device
from metrics_tpu_torch.metric import resolve_device


def _count_ngram(tokens: Sequence[str], n_gram: int) -> Counter:
    """Multiset of all 1..n_gram-grams of ``tokens``."""
    counts: Counter = Counter()
    for n in range(1, n_gram + 1):
        for j in range(len(tokens) - n + 1):
            counts[tuple(tokens[j : j + n])] += 1
    return counts


def _tokenize_fn(sentence: str) -> Sequence[str]:
    return sentence.split()


def _bleu_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int = 4,
    tokenizer: Callable[[str], Sequence[str]] = _tokenize_fn,
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Clipped n-gram matches against the union of the references' n-grams,
    per BLEU order, on the host: ``(numerator, denominator, preds_len,
    target_len)``. The target length takes the closest reference length
    (ties to the shorter)."""
    numerator = np.zeros(n_gram)
    denominator = np.zeros(n_gram)
    preds_len = 0
    target_len = 0
    target_tokens: List[List[Sequence[str]]] = [[tokenizer(line) if line else [] for line in t] for t in target]
    preds_tokens: List[Sequence[str]] = [tokenizer(line) if line else [] for line in preds]

    for pred, refs in zip(preds_tokens, target_tokens):
        preds_len += len(pred)
        ref_lens = [len(ref) for ref in refs]
        closest = min(ref_lens, key=lambda x: (abs(len(pred) - x), x))
        target_len += closest

        pred_counter = _count_ngram(pred, n_gram)
        ref_counter: Counter = Counter()
        for ref in refs:
            ref_counter |= _count_ngram(ref, n_gram)
        clipped = pred_counter & ref_counter
        for ngram, cnt in clipped.items():
            numerator[len(ngram) - 1] += cnt
        for ngram, cnt in pred_counter.items():
            denominator[len(ngram) - 1] += cnt
    return numerator, denominator, preds_len, target_len


def _bleu_stats(numerator: np.ndarray, denominator: np.ndarray, preds_len: int, target_len: int) -> np.ndarray:
    """An update's counters as one host vector ``[preds_len, target_len,
    numerator..., denominator...]``, for one copy to the device."""
    return np.concatenate([[preds_len, target_len], numerator, denominator])


def _bleu_score_compute(
    preds_len: torch.Tensor,
    target_len: torch.Tensor,
    numerator: torch.Tensor,
    denominator: torch.Tensor,
    n_gram: int = 4,
    smooth: bool = False,
) -> torch.Tensor:
    """Geometric mean of the n-gram precisions times the brevity penalty, a
    float32 tensor. A zero numerator gives 0 (read on the host)."""
    if float(numerator.min()) == 0.0:
        return torch.zeros((), dtype=torch.float32, device=numerator.device)
    if smooth:
        precision = torch.cat([numerator[:1] / denominator[:1], (numerator[1:] + 1.0) / (denominator[1:] + 1.0)])
    else:
        precision = numerator / denominator
    log_precision = (1.0 / n_gram) * torch.log(precision)
    geometric_mean = torch.exp(log_precision.sum())
    brevity = torch.where(preds_len > target_len, torch.ones_like(preds_len), torch.exp(1 - target_len / preds_len))
    return (brevity * geometric_mean).to(torch.float32)


def _split_stats(stats: torch.Tensor, n_gram: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    return stats[0], stats[1], stats[2 : 2 + n_gram], stats[2 + n_gram :]


def bleu_score(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    n_gram: int = 4,
    smooth: bool = False,
    device: Optional[Any] = None,
) -> torch.Tensor:
    """BLEU score of machine-translated text against one or more references,
    a float32 tensor on ``device`` (the GPU unless given).

    Example:
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
        >>> round(float(bleu_score(preds, target, device="cpu")), 4)
        0.7598
    """
    preds_ = [preds] if isinstance(preds, str) else list(preds)
    target_ = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]
    if len(preds_) != len(target_):
        raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
    stats = _on_device(_bleu_stats(*_bleu_score_update(preds_, target_, n_gram)), resolve_device(device))
    preds_len, target_len, numerator, denominator = _split_stats(stats, n_gram)
    return _bleu_score_compute(preds_len, target_len, numerator, denominator, n_gram, smooth)

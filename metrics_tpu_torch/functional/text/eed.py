"""Extended edit distance (counterpart of ``metrics_tpu/functional/text/eed.py``).

The published EED measure (Stanchev, Wang, Ney, WMT 2019): a CDER-style
character alignment grid extended with a long jump at blank positions, plus
a coverage penalty for repeated visits. The per-reference-character DP row
is vectorized with numpy: the left-to-right deletion dependency
``next[i] = min(next[i], next[i-1] + del)`` resolves in one pass with
``minimum.accumulate(next - i*del) + i*del``. All of it runs on the host;
the per-sentence scores are float32 tensors on the metric's device.
"""
import re
import unicodedata
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.metric import resolve_device


def _eed_function(
    hyp: str,
    ref: str,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
) -> float:
    """Sentence-level EED between two preprocessed strings (0 best, 1 worst)."""
    n_hyp = len(hyp)
    hyp_chars = np.array(list(hyp), dtype=object) if n_hyp else np.empty(0, dtype=object)
    idx_scaled = np.arange(n_hyp + 1) * deletion

    visits = np.full(n_hyp + 1, -1, dtype=np.int64)
    row = np.ones(n_hyp + 1)
    row[0] = 0.0  # CDER init: only the origin is free

    for ref_char in ref:
        # substitution or match from the diagonal, insertion from above
        if n_hyp:
            sub = row[:-1] + (hyp_chars != ref_char).astype(np.float64)
            ins = row[1:] + insertion
            tail = np.minimum(sub, ins)
            nxt = np.concatenate(([row[0] + 1.0], tail))
        else:
            nxt = np.array([row[0] + 1.0])
        # deletions propagate left to right in one accumulate pass
        nxt = np.minimum.accumulate(nxt - idx_scaled) + idx_scaled
        best = nxt.min()
        # the first minimum within 1e-9: the accumulate's (x - i*del) + i*del
        # round trip adds about 1e-16 of noise, which would break the exact
        # ties of the sequential DP and visit another cell (distinct EED
        # costs are O(0.1) apart, so the tolerance merges no real difference)
        visits[int(np.argmax(nxt <= best + 1e-9))] += 1
        # long jump: from the best cell anywhere, at word boundaries
        if ref_char == " ":
            nxt = np.minimum(nxt, alpha + best)
        row = nxt

    coverage = rho * float(np.where(visits >= 0, visits, 1).sum())
    return min(1.0, (float(row[-1]) + coverage) / (float(len(ref)) + coverage))


def _preprocess_en(sentence: str) -> str:
    """EED's English preprocessing: pad punctuation, rejoin decimals and
    known abbreviations, frame with spaces."""
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    sentence = sentence.rstrip()
    for punct in (".", "!", "?", ","):
        sentence = sentence.replace(punct, f" {punct}")
    sentence = re.sub(r"\s+", " ", sentence)
    sentence = re.sub(r"(\d) ([.,]) (\d)", r"\1\2\3", sentence)
    sentence = re.sub(r"(Dr|Jr|Prof|Rev|Gen|Mr|Mt|Mrs|Ms) .", r"\1.", sentence)
    for spaced, joined in (("e . g .", "e.g."), ("i . e .", "i.e."), ("U . S .", "U.S.")):
        sentence = sentence.replace(spaced, joined)
    return f" {sentence} "


def _preprocess_ja(sentence: str) -> str:
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    return unicodedata.normalize("NFKC", sentence.rstrip())


def _eed_update(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
) -> List[float]:
    """Per-sentence best-over-references EED scores of a batch, on the host."""
    if isinstance(preds, str):
        preds = [preds]
    target = [[t] if isinstance(t, str) else list(t) for t in target]
    if len(preds) != len(target):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")
    if language == "en":
        preprocess = _preprocess_en
    elif language == "ja":
        preprocess = _preprocess_ja
    else:
        raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")

    if 0 in (len(preds), len(target[0]) if target else 0):
        return []

    scores: List[float] = []
    for pred, refs in zip(preds, target):
        hyp = preprocess(pred)
        scores.append(min(_eed_function(hyp, preprocess(ref), alpha, rho, deletion, insertion) for ref in refs))
    return scores


def _eed_compute(sentence_scores: torch.Tensor) -> torch.Tensor:
    """Mean of the per-sentence scores; 0 with none."""
    if sentence_scores.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=sentence_scores.device)
    return sentence_scores.to(torch.float32).mean()


def _check_eed_args(alpha: float, rho: float, deletion: float, insertion: float) -> None:
    for param_name, param in zip(("alpha", "rho", "deletion", "insertion"), (alpha, rho, deletion, insertion)):
        if not isinstance(param, float) or param < 0:
            raise ValueError(f"Parameter `{param_name}` is expected to be a non-negative float.")


def extended_edit_distance(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    return_sentence_level_score: bool = False,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
    device: Optional[Any] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Extended edit distance for machine translation (0 best, 1 worst),
    float32 on ``device`` (the GPU unless given).

    Example:
        >>> preds = ["this is the prediction", "here is an other sample"]
        >>> target = ["this is the reference", "here is another one"]
        >>> round(float(extended_edit_distance(preds=preds, target=target, device="cpu")), 4)
        0.3078
    """
    _check_eed_args(alpha, rho, deletion, insertion)
    dev = resolve_device(device)
    scores = torch.tensor(
        _eed_update(preds, target, language, alpha, rho, deletion, insertion), dtype=torch.float32, device=dev
    )
    average = _eed_compute(scores)
    if return_sentence_level_score:
        return average, scores
    return average

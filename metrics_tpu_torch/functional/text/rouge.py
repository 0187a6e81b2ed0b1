"""ROUGE score (counterpart of ``metrics_tpu/functional/text/rouge.py``).

ROUGE-N, ROUGE-L and ROUGE-Lsum (Lin 2004) with the rouge-score package's
text normalization, on the host. The LCS length is bit-parallel on Python
integers (``_lcs``), the JAX package's integer in fewer operations. The
per-sentence precision, recall and F rows go to the metric's device as
float32 tensors.

``rougeLsum`` splits sentences with nltk's punkt where its data is
installed, else on terminal punctuation, and joins them with newlines; the
tokenizer's ``[^a-z0-9]+`` then removes the newlines again, so Lsum is the
LCS over the flattened tokens (the JAX package's behaviour, kept as it is:
both splitters give the same scores).
"""
import functools
import importlib.util
import re
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from metrics_tpu_torch.metric import resolve_device

ROUGE_STATS = ("fmeasure", "precision", "recall")


@functools.lru_cache(maxsize=None)
def _nltk_available() -> bool:
    return importlib.util.find_spec("nltk") is not None


def _porter_stemmer() -> Any:
    """nltk's Porter stemmer; ``ModuleNotFoundError`` without ``nltk``."""
    if not _nltk_available():
        raise ModuleNotFoundError("Stemmer requires that `nltk` is installed. Use `pip install nltk`.")
    import nltk

    return nltk.stem.porter.PorterStemmer()


ALLOWED_ROUGE_KEYS: Dict[str, Union[int, str]] = {
    **{f"rouge{n}": n for n in range(1, 10)},
    "rougeL": "L",
    "rougeLsum": "Lsum",
}
ALLOWED_ACCUMULATE_VALUES = ("avg", "best")

_SENT_SPLIT_RE = re.compile(r"(?<=[.!?])\s+")


def _split_sentences(x: str) -> List[str]:
    """Sentence segmentation for Lsum: punkt if available, regex fallback."""
    x = x.replace("<n>", "")  # pegasus newline marker
    if _nltk_available():
        import nltk

        try:
            return nltk.sent_tokenize(x)
        except LookupError:
            pass  # punkt's data is not installed
    return [s for s in _SENT_SPLIT_RE.split(x) if s]


def _add_newline_to_end_of_each_sentence(x: str) -> str:
    return "\n".join(_split_sentences(x))


def _normalize_and_tokenize_text(text: str, stemmer: Optional[Any] = None) -> List[str]:
    """Lowercase, strip non-alphanumerics, optionally Porter-stem (>3 chars)."""
    text = re.sub(r"[^a-z0-9]+", " ", text.lower())
    tokens = re.split(r"\s+", text)
    if stemmer:
        tokens = [stemmer.stem(x) if len(x) > 3 else x for x in tokens]
    return [x for x in tokens if isinstance(x, str) and re.match(r"^[a-z0-9]+$", x)]


def _compute_metrics(hits_or_lcs: int, pred_len: int, target_len: int) -> Dict[str, float]:
    precision = hits_or_lcs / pred_len
    recall = hits_or_lcs / target_len
    if precision == recall == 0.0:
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}
    return {
        "precision": precision,
        "recall": recall,
        "fmeasure": 2 * precision * recall / (precision + recall),
    }


def _lcs(pred_tokens: Sequence[str], target_tokens: Sequence[str]) -> int:
    """Longest-common-subsequence length, bit-parallel on Python integers
    (Allison and Dix 1986, in Hyyrö's formulation): bit i of ``v`` is 0 where
    row i of the LCS table steps up, and one add, one subtract and two masks
    advance all of a column. The same integer as the JAX package's numpy
    row-DP, in a few big-integer operations per target token."""
    if not pred_tokens or not target_tokens:
        return 0
    match: Dict[str, int] = {}
    for i, tok in enumerate(pred_tokens):
        match[tok] = match.get(tok, 0) | (1 << i)
    full = (1 << len(pred_tokens)) - 1
    v = full
    for tok in target_tokens:
        u = v & match.get(tok, 0)
        v = ((v + u) | (v - u)) & full
    return len(pred_tokens) - bin(v).count("1")


def _rouge_n_score(pred: Sequence[str], target: Sequence[str], n_gram: int) -> Dict[str, float]:
    """Clipped n-gram overlap precision/recall/F for ROUGE-N."""

    def _create_ngrams(tokens: Sequence[str], n: int) -> Counter:
        out: Counter = Counter()
        for i in range(len(tokens) - n + 1):
            out[tuple(tokens[i : i + n])] += 1
        return out

    pred_ngrams, target_ngrams = _create_ngrams(pred, n_gram), _create_ngrams(target, n_gram)
    pred_len, target_len = sum(pred_ngrams.values()), sum(target_ngrams.values())
    if 0 in (pred_len, target_len):
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}
    hits = sum(min(pred_ngrams[w], target_ngrams[w]) for w in pred_ngrams)
    return _compute_metrics(hits, pred_len, target_len)


def _rouge_l_score(pred: Sequence[str], target: Sequence[str]) -> Dict[str, float]:
    if 0 in (len(pred), len(target)):
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}
    return _compute_metrics(_lcs(pred, target), len(pred), len(target))


def _rouge_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    rouge_keys_values: List[Union[int, str]],
    accumulate: str,
    stemmer: Optional[Any] = None,
) -> Dict[Union[int, str], List[Dict[str, float]]]:
    """Per-sample ROUGE rows; multi-reference handling via ``best`` (pick the
    reference with the highest first-key fmeasure) or ``avg``."""
    results: Dict[Union[int, str], List[Dict[str, float]]] = {k: [] for k in rouge_keys_values}

    for pred_raw, refs_raw in zip(preds, target):
        pred = _normalize_and_tokenize_text(pred_raw, stemmer)
        if "Lsum" in rouge_keys_values:
            pred_lsum = _normalize_and_tokenize_text(_add_newline_to_end_of_each_sentence(pred_raw), stemmer)

        per_ref: List[Dict[Union[int, str], Dict[str, float]]] = []
        for ref_raw in refs_raw:
            tgt = _normalize_and_tokenize_text(ref_raw, stemmer)
            if "Lsum" in rouge_keys_values:
                tgt_lsum = _normalize_and_tokenize_text(_add_newline_to_end_of_each_sentence(ref_raw), stemmer)
            row: Dict[Union[int, str], Dict[str, float]] = {}
            for key in rouge_keys_values:
                if isinstance(key, int):
                    row[key] = _rouge_n_score(pred, tgt, key)
                elif key == "Lsum":
                    row[key] = _rouge_l_score(pred_lsum, tgt_lsum)
                else:
                    row[key] = _rouge_l_score(pred, tgt)
            per_ref.append(row)

        if accumulate == "best":
            first_key = rouge_keys_values[0]
            best_idx = int(np.argmax([r[first_key]["fmeasure"] for r in per_ref]))
            for key in rouge_keys_values:
                results[key].append(per_ref[best_idx][key])
        else:  # avg
            for key in rouge_keys_values:
                results[key].append(
                    {
                        t: float(np.mean([r[key][t] for r in per_ref]))
                        for t in ("fmeasure", "precision", "recall")
                    }
                )
    return results


def _rouge_rows(
    sentence_results: Dict[Union[int, str], List[Dict[str, float]]], rouge_keys_values: List[Union[int, str]]
) -> np.ndarray:
    """An update's per-sentence results as one ``[keys * 3, n]`` host array,
    rows ordered key by key as ``ROUGE_STATS``."""
    return np.array(
        [[row[stat] for row in sentence_results[key]] for key in rouge_keys_values for stat in ROUGE_STATS],
        dtype=np.float64,
    ).reshape(len(rouge_keys_values) * len(ROUGE_STATS), -1)


def _rouge_score_compute(sentence_results: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Mean of each ``<key>_<stat>`` over its sentences (NaN with none)."""
    return {key: scores.to(torch.float32).mean() for key, scores in sentence_results.items()}


def _check_rouge_args(
    rouge_keys: Union[str, Tuple[str, ...]], accumulate: str, use_stemmer: bool
) -> Tuple[Tuple[str, ...], List[Union[int, str]]]:
    if use_stemmer and not _nltk_available():
        raise ModuleNotFoundError("Stemmer requires that `nltk` is installed. Use `pip install nltk`.")
    if not isinstance(rouge_keys, tuple):
        rouge_keys = (rouge_keys,)
    for key in rouge_keys:
        if key not in ALLOWED_ROUGE_KEYS:
            raise ValueError(f"Got unknown rouge key {key}. Expected to be one of {list(ALLOWED_ROUGE_KEYS)}")
    if accumulate not in ALLOWED_ACCUMULATE_VALUES:
        raise ValueError(f"Got unknown accumulate value {accumulate}. Expected one of {ALLOWED_ACCUMULATE_VALUES}")
    return rouge_keys, [ALLOWED_ROUGE_KEYS[key] for key in rouge_keys]


def _normalize_rouge_inputs(
    preds: Union[str, Sequence[str]], target: Union[str, Sequence[str], Sequence[Sequence[str]]]
) -> Tuple[Sequence[str], Sequence[Sequence[str]]]:
    if isinstance(target, list) and all(isinstance(tgt, str) for tgt in target):
        target = [target] if isinstance(preds, str) else [[tgt] for tgt in target]
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [[target]]
    return preds, target


def rouge_score(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    accumulate: str = "best",
    use_stemmer: bool = False,
    rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
    device: Optional[Any] = None,
) -> Dict[str, torch.Tensor]:
    """ROUGE scores for automatic summarization, float32 on ``device`` (the
    GPU unless given).

    Example:
        >>> scores = rouge_score("My name is John", "Is your name John", rouge_keys=("rouge1", "rougeL"), device="cpu")
        >>> {k: round(float(v), 4) for k, v in sorted(scores.items())}  # doctest: +NORMALIZE_WHITESPACE
        {'rouge1_fmeasure': 0.75, 'rouge1_precision': 0.75, 'rouge1_recall': 0.75,
         'rougeL_fmeasure': 0.5, 'rougeL_precision': 0.5, 'rougeL_recall': 0.5}
    """
    rouge_keys, rouge_keys_values = _check_rouge_args(rouge_keys, accumulate, use_stemmer)
    dev = resolve_device(device)
    stemmer = _porter_stemmer() if use_stemmer else None
    preds, target = _normalize_rouge_inputs(preds, target)
    results = _rouge_score_update(preds, target, rouge_keys_values, accumulate, stemmer)
    rows = torch.as_tensor(_rouge_rows(results, rouge_keys_values), dtype=torch.float32).to(dev)
    names = [f"rouge{key}_{stat}" for key in rouge_keys_values for stat in ROUGE_STATS]
    return _rouge_score_compute(dict(zip(names, rows)))

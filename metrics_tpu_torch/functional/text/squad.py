"""SQuAD exact match and F1 (counterpart of ``metrics_tpu/functional/text/squad.py``).

The SQuAD v1 evaluation protocol (Rajpurkar et al. 2016): answers are
normalized (lowercase, punctuation, articles and extra whitespace removed),
each question scores the best over its ground truths, and the means are
given times 100. The string work runs on the host; the F1 and exact-match
sums are float32 tensors on the metric's device and the question count an
int64 one.
"""
import re
import string
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.metric import resolve_device
from metrics_tpu_torch.obs.warn import warn_once

SINGLE_PRED_TYPE = Dict[str, str]
PREDS_TYPE = Union[SINGLE_PRED_TYPE, List[SINGLE_PRED_TYPE]]
SINGLE_TARGET_TYPE = Dict[str, Any]
TARGETS_TYPE = Union[SINGLE_TARGET_TYPE, List[SINGLE_TARGET_TYPE]]

SQuAD_FORMAT = {
    "answers": {"answer_start": [1], "text": ["This is a test text"]},
    "context": "This is a test context.",
    "id": "1",
    "question": "Is this a test?",
    "title": "train test",
}

_ARTICLES_RE = re.compile(r"\b(a|an|the)\b")
_PUNCT = set(string.punctuation)


def _normalize_text(s: str) -> str:
    """Lowercase; drop punctuation, English articles, and extra whitespace."""
    s = "".join(ch for ch in s.lower() if ch not in _PUNCT)
    return " ".join(_ARTICLES_RE.sub(" ", s).split())


def _get_tokens(s: str) -> List[str]:
    return _normalize_text(s).split() if s else []


def _compute_f1_score(predicted_answer: str, target_answer: str) -> float:
    """Token-level F1 between one prediction and one ground-truth answer."""
    target_tokens = _get_tokens(target_answer)
    predicted_tokens = _get_tokens(predicted_answer)
    common = Counter(target_tokens) & Counter(predicted_tokens)
    num_same = sum(common.values())
    if len(target_tokens) == 0 or len(predicted_tokens) == 0:
        # no-answer questions score 1 only when both sides are empty
        return float(target_tokens == predicted_tokens)
    if num_same == 0:
        return 0.0
    precision = num_same / len(predicted_tokens)
    recall = num_same / len(target_tokens)
    return 2 * precision * recall / (precision + recall)


def _compute_exact_match_score(prediction: str, ground_truth: str) -> float:
    return float(_normalize_text(prediction) == _normalize_text(ground_truth))


def _metric_max_over_ground_truths(
    metric_fn: Callable[[str, str], float], prediction: str, ground_truths: List[str]
) -> float:
    return max(metric_fn(prediction, truth) for truth in ground_truths)


def _squad_input_check(preds: PREDS_TYPE, targets: TARGETS_TYPE) -> Tuple[Dict[str, str], List[Dict]]:
    """Validate and normalize inputs to an id→answer map + SQuAD article list."""
    if isinstance(preds, dict):
        preds = [preds]
    if isinstance(targets, dict):
        targets = [targets]

    for pred in preds:
        if "prediction_text" not in pred or "id" not in pred:
            raise KeyError(
                "Expected keys in a single prediction are 'prediction_text' and 'id'. "
                "Please make sure that 'prediction_text' maps to the answer string and 'id' maps to the key string."
            )
    for target in targets:
        if "answers" not in target or "id" not in target:
            raise KeyError(
                "Expected keys in a single target are 'answers' and 'id'. "
                "Please make sure that 'answers' maps to a `SQuAD` format dictionary and 'id' maps to the key "
                f"string.\nSQuAD Format: {SQuAD_FORMAT}"
            )
        if "text" not in target["answers"]:
            raise KeyError(
                "Expected keys in a 'answers' are 'text'. "
                "Please make sure that 'answer' maps to a `SQuAD` format dictionary.\n"
                f"SQuAD Format: {SQuAD_FORMAT}"
            )

    preds_dict = {p["id"]: p["prediction_text"] for p in preds}
    qas = [{"answers": [{"text": txt} for txt in t["answers"]["text"]], "id": t["id"]} for t in targets]
    targets_dict = [{"paragraphs": [{"qas": qas}]}]
    return preds_dict, targets_dict


def _squad_update(preds: Dict[str, str], target: List[Dict]) -> Tuple[float, float, int]:
    """Sums of F1 and exact match, and the question count, over all articles, on the host."""
    f1 = 0.0
    exact_match = 0.0
    total = 0
    for article in target:
        for paragraph in article["paragraphs"]:
            for qa in paragraph["qas"]:
                total += 1
                if qa["id"] not in preds:
                    # one coarse key: question ids are unbounded, and a key
                    # per id would grow the warn-once registry without bound
                    warn_once(
                        f"Unanswered question {qa['id']} will receive score 0.",
                        key="squad_unanswered_question",
                    )
                    continue
                ground_truths = [x["text"] for x in qa["answers"]]
                pred = preds[qa["id"]]
                exact_match += _metric_max_over_ground_truths(_compute_exact_match_score, pred, ground_truths)
                f1 += _metric_max_over_ground_truths(_compute_f1_score, pred, ground_truths)
    return f1, exact_match, total


def _squad_on_device(f1: float, exact_match: float, total: int, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The update's sums as float32 and its count as int64 on ``device``,
    from one host-to-device copy (float64 carries the count exactly)."""
    stats = torch.tensor([f1, exact_match, total], dtype=torch.float64).to(device)
    return stats[0].to(torch.float32), stats[1].to(torch.float32), stats[2].to(torch.int64)


def _squad_compute(f1: torch.Tensor, exact_match: torch.Tensor, total: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"exact_match": 100.0 * exact_match / total, "f1": 100.0 * f1 / total}


def squad(preds: PREDS_TYPE, target: TARGETS_TYPE, device: Optional[Any] = None) -> Dict[str, torch.Tensor]:
    """SQuAD exact match and F1 (times 100) of question-answering
    predictions, float32 on ``device`` (the GPU unless given).

    Example:
        >>> preds = [{"prediction_text": "1976", "id": "56e10a3be3433e1400422b22"}]
        >>> target = [{"answers": {"answer_start": [97], "text": ["1976"]}, "id": "56e10a3be3433e1400422b22"}]
        >>> {k: float(v) for k, v in squad(preds, target, device="cpu").items()}
        {'exact_match': 100.0, 'f1': 100.0}
    """
    dev = resolve_device(device)
    preds_dict, target_dict = _squad_input_check(preds, target)
    return _squad_compute(*_squad_on_device(*_squad_update(preds_dict, target_dict), dev))

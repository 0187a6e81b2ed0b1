"""Hamming distance (counterpart of ``metrics_tpu/functional/classification/hamming.py``)."""
from typing import Tuple, Union

import torch

from metrics_tpu_torch.utils.checks import _input_format_classification


def _hamming_distance_update(preds: torch.Tensor, target: torch.Tensor, threshold: float = 0.5) -> Tuple[torch.Tensor, int]:
    preds, target, _ = _input_format_classification(preds, target, threshold=threshold)
    return (preds == target).sum(), preds.numel()


def _hamming_distance_compute(correct: torch.Tensor, total: Union[int, torch.Tensor]) -> torch.Tensor:
    return 1 - correct.float() / total


def hamming_distance(preds: torch.Tensor, target: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Fraction of wrong labels over all labels of one batch."""
    correct, total = _hamming_distance_update(preds, target, threshold)
    return _hamming_distance_compute(correct, total)

"""Match error rate (counterpart of ``metrics_tpu/functional/text/mer.py``)."""
from typing import Any, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.functional.text.helper import _edit_distance, _on_device
from metrics_tpu_torch.metric import resolve_device


def _mer_update(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tuple[int, int]:
    """Edit operations and ``max(|pred|, |target|)`` words per sample, on the host."""
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    errors = 0
    total = 0
    for pred, tgt in zip(preds, target):
        pred_tokens = pred.split()
        tgt_tokens = tgt.split()
        errors += _edit_distance(pred_tokens, tgt_tokens)
        total += max(len(tgt_tokens), len(pred_tokens))
    return errors, total


def _mer_compute(errors: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    return errors / total


def match_error_rate(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Optional[Any] = None
) -> torch.Tensor:
    """Match error rate: edits over the longer of prediction and reference length.

    Example:
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> round(float(match_error_rate(preds=preds, target=target, device="cpu")), 4)
        0.4444
    """
    errors, total = _on_device(_mer_update(preds, target), resolve_device(device)).unbind()
    return _mer_compute(errors, total)

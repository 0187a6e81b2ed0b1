"""Character error rate (counterpart of ``metrics_tpu/functional/text/cer.py``)."""
from typing import Any, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.functional.text.helper import _edit_distance, _on_device
from metrics_tpu_torch.metric import resolve_device


def _cer_update(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tuple[int, int]:
    """Character-level edit operations and reference characters, on the host."""
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    errors = 0
    total = 0
    for pred, tgt in zip(preds, target):
        errors += _edit_distance(list(pred), list(tgt))
        total += len(tgt)
    return errors, total


def _cer_compute(errors: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    return errors / total


def char_error_rate(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Optional[Any] = None
) -> torch.Tensor:
    """Character error rate for speech or OCR transcripts (0 = perfect).

    Example:
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> round(float(char_error_rate(preds=preds, target=target, device="cpu")), 4)
        0.3415
    """
    errors, total = _on_device(_cer_update(preds, target), resolve_device(device)).unbind()
    return _cer_compute(errors, total)

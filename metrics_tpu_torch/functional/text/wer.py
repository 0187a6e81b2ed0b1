"""Word error rate (counterpart of ``metrics_tpu/functional/text/wer.py``)."""
from typing import Any, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.functional.text.helper import _edit_distance, _on_device
from metrics_tpu_torch.metric import resolve_device


def _wer_update(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tuple[int, int]:
    """Edit operations and reference words of a batch of transcripts, on the host."""
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
        total += len(tgt_tokens)
    return errors, total


def _wer_compute(errors: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    return errors / total


def word_error_rate(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Optional[Any] = None
) -> torch.Tensor:
    """Word error rate for speech-recognition transcripts (0 = perfect), as
    a float32 tensor on ``device`` (the GPU unless given).

    Example:
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> round(float(word_error_rate(preds=preds, target=target, device="cpu")), 4)
        0.5
    """
    errors, total = _on_device(_wer_update(preds, target), resolve_device(device)).unbind()
    return _wer_compute(errors, total)

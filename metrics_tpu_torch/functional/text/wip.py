"""Word information preserved (counterpart of ``metrics_tpu/functional/text/wip.py``).

Hits are counted positive, ``max(|pred|, |target|) - edit_distance``, as in
the JAX package.
"""
from typing import Any, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.functional.text.helper import _edit_distance, _on_device
from metrics_tpu_torch.metric import resolve_device


def _wip_update(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tuple[int, int, int]:
    """Word hits and the word counts of both sides, on the host."""
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    hits = 0
    target_total = 0
    preds_total = 0
    for pred, tgt in zip(preds, target):
        pred_tokens = pred.split()
        tgt_tokens = tgt.split()
        hits += max(len(tgt_tokens), len(pred_tokens)) - _edit_distance(pred_tokens, tgt_tokens)
        target_total += len(tgt_tokens)
        preds_total += len(pred_tokens)
    return hits, target_total, preds_total


def _wip_compute(hits: torch.Tensor, target_total: torch.Tensor, preds_total: torch.Tensor) -> torch.Tensor:
    return (hits / target_total) * (hits / preds_total)


def word_information_preserved(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Optional[Any] = None
) -> torch.Tensor:
    """Word information preserved: ``(H/N_ref) * (H/N_hyp)``.

    Example:
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> round(float(word_information_preserved(preds, target, device="cpu")), 4)
        0.3472
    """
    hits, target_total, preds_total = _on_device(_wip_update(preds, target), resolve_device(device)).unbind()
    return _wip_compute(hits, target_total, preds_total)

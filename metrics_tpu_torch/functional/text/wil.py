"""Word information lost (counterpart of ``metrics_tpu/functional/text/wil.py``)."""
from typing import Any, List, Optional, Tuple, Union

import torch

from metrics_tpu_torch.functional.text.helper import _on_device
from metrics_tpu_torch.functional.text.wip import _wip_update
from metrics_tpu_torch.metric import resolve_device


def _wil_update(preds: Union[str, List[str]], target: Union[str, List[str]]) -> Tuple[int, int, int]:
    return _wip_update(preds, target)


def _wil_compute(hits: torch.Tensor, target_total: torch.Tensor, preds_total: torch.Tensor) -> torch.Tensor:
    return 1 - (hits / target_total) * (hits / preds_total)


def word_information_lost(
    preds: Union[str, List[str]], target: Union[str, List[str]], device: Optional[Any] = None
) -> torch.Tensor:
    """Word information lost: ``1 - (H/N_ref) * (H/N_hyp)``.

    Example:
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> round(float(word_information_lost(preds, target, device="cpu")), 4)
        0.6528
    """
    hits, target_total, preds_total = _on_device(_wil_update(preds, target), resolve_device(device)).unbind()
    return _wil_compute(hits, target_total, preds_total)

"""Host-side helpers shared by the text metrics (counterpart of
``metrics_tpu/functional/text/helper.py``).

Strings never reach the device: tokenization, n-gram counting and the
alignment DPs run on the host, and only the counters they produce go to the
metric's device. :func:`_on_device` makes one update's numbers one tensor
with one host-to-device copy; a metric splits it into its states.
"""
from typing import Sequence, Union

import numpy as np
import torch


def _edit_distance(prediction_tokens: Sequence, reference_tokens: Sequence) -> int:
    """Word- or character-level Levenshtein distance with unit costs.

    Vectorized row-DP: for each prediction token the new row is
    ``min(delete, substitute)`` elementwise, then the left-to-right insertion
    dependency ``cur[j] = min(cur[j], cur[j-1] + 1)`` resolves in one pass
    with the ``minimum.accumulate(cur - j) + j`` identity.
    """
    m, n = len(prediction_tokens), len(reference_tokens)
    if m == 0:
        return n
    if n == 0:
        return m
    ref = np.asarray(reference_tokens, dtype=object)
    prev = np.arange(n + 1)
    for i, pred_tok in enumerate(prediction_tokens, start=1):
        cost = (ref != pred_tok).astype(np.int64)
        cur_tail = np.minimum(prev[1:] + 1, prev[:-1] + cost)
        cur = np.concatenate(([i], cur_tail))
        cur = np.minimum.accumulate(cur - np.arange(n + 1)) + np.arange(n + 1)
        prev = cur
    return int(prev[-1])


def _on_device(
    values: Union[Sequence[float], np.ndarray], device: torch.device, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Host numbers as one 1-d tensor on ``device``: one host-to-device copy
    however many counters an update carries. float32 counts are exact up to
    2^24 per counter."""
    return torch.as_tensor(np.asarray(values, dtype=np.float64).reshape(-1), dtype=dtype).to(device)

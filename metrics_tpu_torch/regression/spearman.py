"""SpearmanCorrCoef module metric (counterpart of ``metrics_tpu/regression/spearman.py``)."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.regression.spearman import _spearman_corrcoef_compute, _spearman_corrcoef_update
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.utils.bounded import _BoundedSampleBufferMixin


class SpearmanCorrCoef(_BoundedSampleBufferMixin, Metric):
    """Spearman rank correlation; buffers the whole stream, since ranks are global.

    Args:
        buffer_capacity: fix the sample buffers to this many samples (fixed
            memory, exact results, an overflow raises at ``compute``).
            ``None`` keeps unbounded lists.
        device: see :class:`~metrics_tpu_torch.metric.Metric`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import SpearmanCorrCoef
        >>> spearman = SpearmanCorrCoef(device="cpu")
        >>> print(round(float(spearman(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))), 4))
        1.0
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(self, buffer_capacity: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._init_sample_states(
            buffer_capacity,
            specs=(("preds", None, None), ("target", None, None)),
            # the JAX package's warning text, 'SpearmanCorrcoef' spelling included
            warn_message=(
                "Metric `SpearmanCorrcoef` will save all targets and predictions in the buffer."
                " For large datasets, this may lead to large memory footprint."
            ),
        )

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        preds, target = _spearman_corrcoef_update(preds, target)
        self._append_samples(preds, target)

    def compute(self) -> torch.Tensor:
        preds, target = self._collect_samples()
        return _spearman_corrcoef_compute(preds, target)

"""ConfusionMatrix module metric (counterpart of ``metrics_tpu/classification/confusion_matrix.py``)."""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _confusion_matrix_compute,
    _confusion_matrix_update,
)
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.sharding.spec import canonical_spec, class_axis_spec


class ConfusionMatrix(Metric):
    """Streaming confusion matrix, an int64 ``[C, C]`` sum state (rows = true,
    cols = predicted), or ``[C, 2, 2]`` with ``multilabel=True``.

    Args:
        num_classes: size C of the matrix.
        normalize: ``none``, ``true`` (rows sum to 1), ``pred`` (columns sum
            to 1) or ``all``.
        threshold: probability cutoff binarizing probabilistic inputs.
        multilabel: treat inputs as [N, C] independent binary problems.
        class_sharding: a mesh-axis name (or a ``PartitionSpec``) the class
            axis of the state is split over; once placed
            (``shard_states(mesh)`` or ``drive(mesh=, in_specs=)``) each
            process counts only its rows with the class-windowed kernels.
        device: see :class:`~metrics_tpu_torch.metric.Metric`.
    """

    is_differentiable = False
    higher_is_better = None
    # a bincount of per-row (target, pred) pairs: row-additive, so `jit_bucket`
    # padding corrects exactly
    _batch_additive = True
    _sharded_update = True

    def __init__(
        self,
        num_classes: int,
        normalize: Optional[str] = None,
        threshold: float = 0.5,
        multilabel: bool = False,
        class_sharding: Optional[Any] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.normalize = normalize
        self.threshold = threshold
        self.multilabel = multilabel

        allowed_normalize = ("true", "pred", "all", "none", None)
        if normalize not in allowed_normalize:
            raise ValueError(f"Argument average needs to one of the following: {allowed_normalize}")

        # a canonical tuple, not a PartitionSpec: public attributes key the
        # engine's programs, and ("mp",) is one key for P("mp") and P("mp", None)
        self.class_sharding = canonical_spec(class_axis_spec(class_sharding)) or None

        shape = (num_classes, 2, 2) if multilabel else (num_classes, num_classes)
        self.add_state(
            "confmat", default=torch.zeros(shape, dtype=torch.int64), dist_reduce_fx="sum", sharding=self.class_sharding
        )

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        # a placed state split over classes: this process's rows alone
        window = self._state_window("confmat")
        confmat = _confusion_matrix_update(
            preds, target, self.num_classes, self.threshold, self.multilabel, window=window
        )
        if window is None:
            confmat = self._local_part("confmat", confmat)
        self.confmat = self.confmat + confmat

    def compute(self) -> torch.Tensor:
        return _confusion_matrix_compute(self.confmat, self.normalize)

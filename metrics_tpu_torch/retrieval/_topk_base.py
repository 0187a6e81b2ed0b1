"""The constructor shared by the retrieval metrics with a top-``k`` argument
(counterpart of ``metrics_tpu/retrieval/_topk_base.py``)."""
from typing import Any, Optional

from metrics_tpu_torch.functional.retrieval._ranking import _validate_k
from metrics_tpu_torch.retrieval.base import RetrievalMetric


class _TopKRetrievalMetric(RetrievalMetric):
    def __init__(
        self, empty_target_action: str = "neg", ignore_index: Optional[int] = None, k: Optional[int] = None, **kwargs: Any
    ) -> None:
        super().__init__(empty_target_action=empty_target_action, ignore_index=ignore_index, **kwargs)
        _validate_k(k)
        self.k = k

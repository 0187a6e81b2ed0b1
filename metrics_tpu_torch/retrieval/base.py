"""``RetrievalMetric``: metrics taken per query, then averaged over queries
(counterpart of ``metrics_tpu/retrieval/base.py``).

``update`` buffers ``(indexes, preds, target)``; ``compute`` groups the
rows by query with one sort (``functional/retrieval/_ranking.py``) and
takes every query's value at once. With ``buffer_capacity`` the buffers are
fixed tensors and ``update`` runs as one program (a CUDA graph on the card);
without it they are lists and the update runs eagerly, as in the JAX
package. The compute reads the number of queries from the data, so it runs
eagerly in both packages.
"""
from abc import ABC, abstractmethod
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.retrieval._ranking import GroupedRanking, _group_by_query, _segment_sum
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops.safe_ops import safe_divide
from metrics_tpu_torch.utils.bounded import _BoundedSampleBufferMixin
from metrics_tpu_torch.utils.checks import _check_retrieval_inputs


class RetrievalMetric(_BoundedSampleBufferMixin, Metric, ABC):
    """Base of the retrieval metrics. ``update(preds, target, indexes)``,
    where ``indexes`` names each row's query; a subclass gives the ``[Q]``
    per-query values in ``_metric_grouped``.

    Args:
        empty_target_action: what a query with no positive target (no
            negative one, for fall-out) gives: ``"neg"`` 0, ``"pos"`` 1,
            ``"skip"`` left out of the mean, ``"error"`` raises.
        ignore_index: rows whose target equals it are dropped.
        buffer_capacity: hold the rows in fixed buffers of this many rows
            (exact; raises at ``compute`` if more came): ``update`` then runs
            as one program, ``ignore_index`` included (its rows are masked
            out on the way in and do not count). ``None``: unbounded lists.
        kwargs: see :class:`~metrics_tpu_torch.metric.Metric`.
    """

    higher_is_better = True

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        buffer_capacity: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.allow_non_binary_target = False

        empty_target_action_options = ("error", "skip", "neg", "pos")
        if empty_target_action not in empty_target_action_options:
            raise ValueError(f"Argument `empty_target_action` received a wrong value `{empty_target_action}`.")
        self.empty_target_action = empty_target_action

        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError("Argument `ignore_index` must be an integer or None.")
        self.ignore_index = ignore_index

        # graded NDCG targets need a float buffer; integer targets fit it exactly
        self._init_sample_states(
            buffer_capacity,
            specs=(("indexes", None, torch.int32), ("preds", None, None), ("target", None, None)),
            warn=False,
        )

    def update(self, preds: torch.Tensor, target: torch.Tensor, indexes: torch.Tensor) -> None:
        if indexes is None:
            raise ValueError("Argument `indexes` cannot be None")
        if self.buffer_capacity is not None and self.ignore_index is not None:
            # no boolean mask (its shape depends on the data): ignored rows
            # get a benign target and the row mask drops them in the append
            valid = (target != self.ignore_index).reshape(-1)
            target = torch.where(target == self.ignore_index, torch.zeros_like(target), target)
            indexes, preds, target = _check_retrieval_inputs(
                indexes, preds, target, allow_non_binary_target=self.allow_non_binary_target, ignore_index=None
            )
            self._append_samples(indexes, preds, target, valid=valid)
            return
        indexes, preds, target = _check_retrieval_inputs(
            indexes, preds, target, allow_non_binary_target=self.allow_non_binary_target, ignore_index=self.ignore_index
        )
        self._append_samples(indexes, preds, target)

    def _empty_query_mask(self, g: GroupedRanking) -> torch.Tensor:
        """``[Q]`` True where a query has no positive target."""
        return _segment_sum(g.target.to(torch.float32), g) == 0

    def _empty_query_error(self) -> str:
        return "`compute` method was provided with a query with no positive target."

    def compute(self) -> torch.Tensor:
        indexes, preds, target = (x.reshape(-1) for x in self._collect_samples())
        g = _group_by_query(preds, target, indexes)
        values = self._metric_grouped(preds, target, indexes, g)
        empty = self._empty_query_mask(g)

        if self.empty_target_action == "error":
            if bool(empty.any()):
                raise ValueError(self._empty_query_error())
            return values.mean()
        if self.empty_target_action == "skip":
            keep = ~empty
            n_keep = keep.sum()
            return torch.where(n_keep > 0, safe_divide(torch.where(keep, values, 0.0).sum(), n_keep), 0.0)
        fill = 1.0 if self.empty_target_action == "pos" else 0.0
        return torch.where(empty, fill, values).mean()

    @abstractmethod
    def _metric_grouped(
        self, preds: torch.Tensor, target: torch.Tensor, indexes: torch.Tensor, g: GroupedRanking
    ) -> torch.Tensor:
        """``[Q]`` per-query values (the base overwrites the empty queries')."""

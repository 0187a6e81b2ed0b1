"""Capacity-bounded sample buffers for the sample-buffer metrics (counterpart
of ``metrics_tpu/utils/bounded.py``).

A curve metric buffers every prediction and target until ``compute``. With
``buffer_capacity=N`` its list states become fixed tensors (one ``[N]`` or
``[N, width]`` buffer per column) plus a ``count`` of the rows seen: memory
is fixed and results stay exact. ``count`` keeps the true number of rows, and
collecting raises if it ever passed the capacity, so rows are never dropped
silently. Bounded buffers use ``dist_reduce_fx=None``.
"""
from typing import Any, Optional, Sequence, Tuple

import torch

from metrics_tpu_torch.obs.warn import warn_once
from metrics_tpu_torch.utils.data import dim_zero_cat

# (state name, row width (None/1 -> 1-D buffer), dtype (None: the default float))
BufferSpec = Tuple[str, Optional[int], Any]

# appended to the curve family's rank-mismatch errors
CURVE_MULTILABEL_HINT = (
    " (For multi-label inputs pass `multilabel=True` together with"
    " `num_classes` so the bounded buffers register [capacity, num_classes]"
    " target rows; the Binned* variants remain the constant-memory"
    " approximation alternative.)"
)


def curve_buffer_specs(
    num_classes: Optional[int], multilabel: bool, buffer_capacity: Optional[int]
) -> Optional[Sequence[BufferSpec]]:
    """Buffer specs for the curve family's ``(preds, target)`` states:
    ``None`` (``[cap, C]`` float preds and ``[cap]`` int class targets) unless
    ``multilabel=True``, which registers ``[cap, num_classes]`` rows for both."""
    if not multilabel:
        return None
    if buffer_capacity is None:
        raise ValueError(
            "`multilabel=True` is a `buffer_capacity` declaration: without a"
            " capacity the unbounded lists infer multi-label layout from the"
            " data and the flag must be omitted."
        )
    if not num_classes:
        raise ValueError("Bounded multi-label buffers need `num_classes` up front.")
    return (("preds", num_classes, None), ("target", num_classes, torch.int32))


class _BoundedSampleBufferMixin:
    """Sample buffers with an optional ``buffer_capacity``.

    The host class calls :meth:`_init_sample_states` from ``__init__`` (after
    ``super().__init__``), :meth:`_append_samples` from ``update`` and
    :meth:`_collect_samples` from ``compute``; each branches on the capacity.
    """

    def _init_sample_states(
        self,
        capacity: Optional[int],
        num_classes: Optional[int] = None,
        specs: Optional[Sequence[BufferSpec]] = None,
    ) -> None:
        if specs is None:  # the curve default: scores and integer labels
            specs = (("preds", num_classes, None), ("target", None, torch.int32))
        self._buffer_specs = tuple(specs)
        self.buffer_capacity = capacity
        if capacity is not None:
            self._init_bounded_buffers(capacity, self._buffer_specs)
            return
        for name, _, _ in self._buffer_specs:
            self.add_state(name, default=[], dist_reduce_fx="cat")
        warn_once(
            f"Metric `{type(self).__name__}` will save all targets and predictions in buffer."
            " For large datasets this may lead to large memory footprint."
        )

    def _append_samples(self, *rows: torch.Tensor) -> None:
        if self.buffer_capacity is not None:
            self._bounded_append(*rows)
        else:
            for (name, _, _), value in zip(self._buffer_specs, rows):
                getattr(self, name).append(value)

    def _collect_samples(self) -> Tuple[torch.Tensor, ...]:
        if self.buffer_capacity is not None:
            return self._bounded_collect()
        return tuple(dim_zero_cat(getattr(self, name)) for name, _, _ in self._buffer_specs)

    def _init_bounded_buffers(self, capacity: int, specs: Sequence[BufferSpec]) -> None:
        if not isinstance(capacity, int) or capacity <= 0:
            raise ValueError(f"`buffer_capacity` must be a positive integer, got {capacity!r}.")
        for name, width, dtype in specs:
            shape = (capacity,) if not width or width == 1 else (capacity, width)
            self.add_state(name, default=torch.zeros(shape, dtype=dtype or torch.get_default_dtype()), dist_reduce_fx=None)
        self.add_state("count", default=torch.tensor(0, dtype=torch.int32), dist_reduce_fx=None)

    def _bounded_append(self, *rows: torch.Tensor) -> None:
        """Write the rows at the current offset. Rows past the capacity go to
        a spare row that is cut off, while ``count`` keeps the true total, so
        an overflow is found at collection."""
        rows = tuple(torch.atleast_1d(value) for value in rows)
        for (name, _, _), value in zip(self._buffer_specs, rows):
            buf = getattr(self, name)
            if value.ndim != buf.ndim:
                raise ValueError(
                    f"`buffer_capacity` mode registered state `{name}` with rank {buf.ndim}"
                    f" rows, but update produced rank-{value.ndim} rows." + CURVE_MULTILABEL_HINT
                )
        n = rows[0].shape[0]
        idx = (self.count + torch.arange(n, device=self.count.device)).clamp(max=self.buffer_capacity)
        for (name, _, _), value in zip(self._buffer_specs, rows):
            buf = getattr(self, name)
            # states are replaced, never written in place: write into a copy with one spare row
            grown = torch.cat([buf, buf.new_zeros((1, *buf.shape[1:]))])
            grown.index_copy_(0, idx, value.to(buf.dtype))
            setattr(self, name, grown[: self.buffer_capacity])
        self.count = self.count + n

    def _bounded_collect(self) -> Tuple[torch.Tensor, ...]:
        """The valid rows of each buffer; raises if the capacity was passed."""
        seen = int(self.count)
        if seen > self.buffer_capacity:
            raise ValueError(
                f"buffer_capacity exceeded: a rank saw {seen} samples"
                f" but the buffer holds {self.buffer_capacity}. Raise `buffer_capacity`"
                " (results would otherwise silently drop samples)."
            )
        return tuple(getattr(self, name)[:seen] for name, _, _ in self._buffer_specs)

"""Opt-in shape bucketing: pad the batch axis to power-of-two buckets
(counterpart of ``metrics_tpu/engine/bucketing.py``).

Each distinct batch shape is its own update program (a CUDA graph is
captured for fixed shapes, as ``jax.jit`` traces for fixed avals), so a
stream with ragged batches (7, 1000, 8192, ...) captures an unbounded number
of graphs. With ``jit_bucket="pow2"`` the batch axis is padded up to the next
power of two before the program runs, which caps the graphs at
O(log max_batch).

Correctness comes from *row-additivity*: a metric that declares
``_batch_additive = True`` (the stat-scores family, the confusion matrix,
sum and mean aggregation, the regression error sums) adds each batch row's
contribution independently to every ``"sum"`` state. Padding appends
all-zero rows and the program subtracts their contribution exactly::

    corrected = update(state, padded) - pad_count * (update(default, zero_row) - default)

``pad_count`` is a device scalar, so every pad amount of one bucket shares
one program. Integer counts are bit-exact; float sums differ only in the
order of the additions. Zero rows keep the correction finite when the stream
itself carries ±inf.

Metrics outside the contract (max/min states, ``ignore_index`` under macro
reduce, list buffers) keep exact-shape programs. The same zero-row
correction implements ``on_bad_input="mask"`` (``resilience/health.py``).

The ``_batch_additive`` contract:

* every registered state is a tensor with ``dist_reduce_fx="sum"``;
* ``update`` reads axis 0 of every tensor input of rank >= 1 as the batch axis;
* each row's contribution to every state is independent of the other rows
  and of the accumulated state.
"""
from typing import Any, Dict, List, Optional, Tuple

import torch

from metrics_tpu_torch.engine import _tree
from metrics_tpu_torch.obs import bus as _bus

#: spec = (leaves, treedef, batched_leaf_indices, pad_count)
BucketSpec = Tuple[List[Any], Any, Tuple[int, ...], int]


def emit_bucket_event(source: str, batch: int, pad: int) -> None:
    """One ``bucketed`` event (no-op while the bus is off): which batch
    went to which pow2 bucket, at the cost of how many pad rows. ``batch``
    and ``pad`` are Python ints taken from shapes."""
    if _bus.enabled():
        _bus.emit("bucketed", source=source, batch=batch, pad=pad, bucket=batch + pad)


def next_pow2(n: int) -> int:
    """Smallest power of two >= ``n`` (``n >= 1``)."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def row_additive_states(metric: Any) -> bool:
    """The state half of the contract: every state a ``"sum"``-reduced
    tensor. Shared with ``resilience/health.mask_supported``."""
    return all(
        not isinstance(metric._defaults[n], list) and metric._reductions[n] == "sum" for n in metric._defaults
    )


def supports_bucketing(metric: Any) -> bool:
    """The class opted into row-additivity and every state is a ``"sum"``
    tensor. A screening prescreen that reshapes the inputs (the aggregators
    flatten rank >= 2 values) redefines what a row is, so such metrics keep
    exact shapes while a health policy is active."""
    if not getattr(metric, "_batch_additive", False) or not row_additive_states(metric):
        return False
    if getattr(metric, "on_bad_input", "propagate") != "propagate":
        from metrics_tpu_torch.metric import Metric

        if type(metric)._health_prescreen is not Metric._health_prescreen:
            return False
    return True


def bucketing_active(metric: Any, batched: Tuple[int, ...]) -> bool:
    """Whether pow2 batch bucketing applies to a dispatch with these batched
    leaf indices: the opt-in, the contract and a batch axis. The gate the
    serving bank (padding ragged requests) and the request router (grouping
    batch sizes by bucket) share."""
    return getattr(metric, "jit_bucket", None) == "pow2" and supports_bucketing(metric) and bool(batched)


def batched_leaf_indices(leaves: List[Any]) -> Tuple[int, ...]:
    """Indices of the tensor leaves of rank >= 1 that share axis 0: the
    batch-axis rule shared by bucketing and row masking. Empty when there is
    no such tensor, the batch is empty, or axis 0 disagrees."""
    batch: Optional[int] = None
    batched: List[int] = []
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor) and leaf.ndim >= 1:
            if batch is None:
                batch = int(leaf.shape[0])
            elif int(leaf.shape[0]) != batch:
                return ()
            batched.append(i)
    if batch in (None, 0):
        return ()
    return tuple(batched)


def input_spec(args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> Optional[BucketSpec]:
    """Flatten the update inputs and find the batch axis; None when there is
    no unambiguous one."""
    leaves, treedef = _tree.flatten((args, kwargs))
    batched = batched_leaf_indices(leaves)
    if not batched:
        return None
    batch = int(leaves[batched[0]].shape[0])
    return leaves, treedef, batched, next_pow2(batch) - batch


def bucket_spec(metric: Any, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> Optional[BucketSpec]:
    """The whole gate for one metric: the opt-in, the contract, the inputs."""
    if getattr(metric, "jit_bucket", None) != "pow2" or not supports_bucketing(metric):
        return None
    return input_spec(args, kwargs)


def pad_leaves(leaves: List[Any], batched: Tuple[int, ...], pad: int) -> List[Any]:
    """The batched leaves with ``pad`` zero rows appended (before the program,
    which sees only bucket shapes)."""
    batched_set = set(batched)
    out: List[Any] = []
    for i, leaf in enumerate(leaves):
        if i in batched_set and pad:
            leaf = torch.cat([leaf, leaf.new_zeros((pad, *leaf.shape[1:]))])
        out.append(leaf)
    return out


def row_slice_leaves(leaves: List[Any], batched: Tuple[int, ...]) -> List[Any]:
    """The one-row inputs of a pad row: a zeroed ``[1, ...]`` slice of each
    batched leaf."""
    batched_set = set(batched)
    return [torch.zeros_like(leaf[-1:]) if i in batched_set else leaf for i, leaf in enumerate(leaves)]

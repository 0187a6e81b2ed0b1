"""Encode-then-accumulate streaming driver (counterpart of
``metrics_tpu/encoders/stream.py``).

:func:`encode_stream` folds a corpus of batches into a carry without ever
holding the corpus's features:

* **One fused program per chunk signature.** Each chunk dispatches through
  the encoder's ``encode_acc`` entry (``engine/cache.py``): the forward and
  ``consumer(carry, features, valid) -> carry`` in one program, a CUDA
  graph on the card.
* **Staging outside the program.** A capture refuses a copy from the host,
  so host batches (numpy arrays or CPU tensors) are pinned and copied to
  the encoder's device on a copy stream before the dispatch; the compute
  stream waits for the copy, and the host goes on to the next chunk while
  the card runs this one.
* **Ragged chunks share a program.** The batch axis is padded with zero rows
  to the next power of two (``engine/bucketing.py``), and a float ``valid``
  row mask (a runtime input) excludes the pad rows from the accumulation.
* **Rows split over the data axes.** A placed encoder with ``in_specs``
  is given the whole chunk: the bucket is rounded up to its
  ``batch_multiple()``, so the chunk and its ``valid`` mask split evenly,
  and each process encodes its rows. The counts (``stream_chunks``,
  ``rows_encoded``) are of the whole chunk, so a row counts once across the
  mesh, not once per process that encodes it.
* **Screening upstream of the encoder.** A metric's ``on_bad_input`` policy
  applies to the raw inputs before the forward: a quarantined batch never
  pays for it, masked rows are zeroed and excluded through ``valid``. The
  counts land in the owning metric's ``health_report()``.

Every chunk counts in :func:`~metrics_tpu_torch.encoders.runtime.encoder_stats`
and, while the event bus records, emits one ``encode`` event, as the JAX
driver does.
"""
from typing import Any, Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.encoders import runtime as _runtime
from metrics_tpu_torch.engine import bucketing as _bucketing
from metrics_tpu_torch.obs import bus as _bus
from metrics_tpu_torch.resilience import health as _health

__all__ = ["StreamResult", "encode_stream"]


class StreamResult:
    """What one :func:`encode_stream` did: ``chunks`` dispatched, ``rows``
    accumulated (pad rows excluded), ``rows_screened`` masked out by the
    health policy, ``batches_quarantined`` dropped whole."""

    __slots__ = ("chunks", "rows", "rows_screened", "batches_quarantined")

    def __init__(self) -> None:
        self.chunks = 0
        self.rows = 0
        self.rows_screened = 0
        self.batches_quarantined = 0

    def __repr__(self) -> str:
        return (
            f"StreamResult(chunks={self.chunks}, rows={self.rows},"
            f" rows_screened={self.rows_screened},"
            f" batches_quarantined={self.batches_quarantined})"
        )


def _as_batches(batches: Any) -> Iterable[Tuple[Any, ...]]:
    for item in batches:
        items = tuple(item) if isinstance(item, (tuple, list)) else (item,)
        yield tuple(torch.from_numpy(np.asarray(x)) if isinstance(x, np.ndarray) else x for x in items)


def _contamination(inputs: Tuple[Any, ...], nan_only: bool) -> Tuple[Optional[torch.Tensor], int, int]:
    """Per-row contamination over the float inputs, where they lie. Returns
    ``(bad_rows_or_None, nan_count, inf_count)``; the counts are one copy to
    the host."""
    batched = _bucketing.batched_leaf_indices(list(inputs))
    floats = [inputs[i] for i in batched if inputs[i].is_floating_point()]
    if not floats:
        return None, 0, 0
    n = int(inputs[batched[0]].shape[0])
    bad = None
    nan_i = inf_i = None
    for x in floats:
        flat = x.reshape(n, -1)
        isnan = torch.isnan(flat)
        isinf = torch.zeros_like(isnan) if nan_only else torch.isinf(flat)
        nan_i = isnan.sum() if nan_i is None else nan_i + isnan.sum()
        inf_i = isinf.sum() if inf_i is None else inf_i + isinf.sum()
        rows = (isnan | isinf).any(dim=1).to(floats[0].device)
        bad = rows if bad is None else bad | rows
    nan_count, inf_count = torch.stack([nan_i, inf_i.to(nan_i.device)]).tolist()
    return bad, int(nan_count), int(inf_count)


def _bump_health(screen: Any, nan_i: int, inf_i: int, masked: int = 0, quarantined: int = 0) -> None:
    """Credit the pre-encoder screen to the owning metric's health counters
    (the same slots the per-step screen bumps)."""
    if screen is None or not _health.health_enabled(screen):
        return
    counts = getattr(screen, _health.HEALTH_STATE)
    delta = [0] * _health.N_SLOTS
    delta[_health.SLOT_NAN], delta[_health.SLOT_INF] = nan_i, inf_i
    delta[_health.SLOT_MASKED], delta[_health.SLOT_QUARANTINED] = masked, quarantined
    setattr(screen, _health.HEALTH_STATE, counts + torch.tensor(delta, dtype=counts.dtype).to(counts.device))


def _screen_batch(
    inputs: Tuple[Any, ...], policy: str, nan_only: bool, screen: Any, result: StreamResult
) -> Optional[Tuple[Tuple[Any, ...], Optional[torch.Tensor], int]]:
    """Apply one ``on_bad_input`` policy upstream of the encoder. Returns
    ``(inputs, keep_mask, n_bad)``; None means the whole batch is
    quarantined (the encoder is never called)."""
    if policy == "propagate":
        return inputs, None, 0
    stats = getattr(screen, "_health_stats", None)
    if stats is not None:
        stats["batches_screened"] = stats.get("batches_screened", 0) + 1
    bad, nan_i, inf_i = _contamination(inputs, nan_only)
    if bad is None or nan_i + inf_i == 0:
        _bump_health(screen, nan_i, inf_i)
        return inputs, None, 0
    n_bad = int(bad.sum())
    if _bus.enabled():
        _bus.emit(
            "quarantine",
            source=type(screen).__name__ if screen is not None else "encode_stream",
            policy=policy,
            nan_count=nan_i,
            inf_count=inf_i,
            path="pre_encode",
        )
    if policy == "raise":
        _bump_health(screen, nan_i, inf_i, quarantined=1)
        raise _health.NumericalHealthError(
            f"encode_stream: batch carries {n_bad} contaminated row(s)"
            f" ({nan_i} nan / {inf_i} inf elements) and the owning metric's"
            " on_bad_input policy is 'raise'. Screened BEFORE the encoder"
            " forward: the contamination is in the raw inputs."
        )
    if policy == "skip":
        result.batches_quarantined += 1
        result.rows_screened += n_bad
        _runtime.count("batches_quarantined")
        _runtime.count("rows_screened", n_bad)
        _bump_health(screen, nan_i, inf_i, quarantined=1)
        return None
    # mask: zero the contaminated rows so the encoder sees finite inputs,
    # and hand the keep-mask down so `valid` excludes them exactly
    batched = set(_bucketing.batched_leaf_indices(list(inputs)))
    masked: List[Any] = []
    for i, x in enumerate(inputs):
        if i in batched and x.is_floating_point():
            x = x.masked_fill(bad.to(x.device).view(-1, *([1] * (x.ndim - 1))), 0)
        masked.append(x)
    result.rows_screened += n_bad
    _runtime.count("rows_screened", n_bad)
    _bump_health(screen, nan_i, inf_i, masked=n_bad)
    return tuple(masked), ~bad, n_bad


_COPY_STREAMS: dict = {}


def _stage(x: Any, device: torch.device) -> Any:
    """One input on the encoder's device: a host tensor is pinned and copied
    on the device's copy stream, which the compute stream then waits for."""
    if not isinstance(x, torch.Tensor) or x.device == device:
        return x
    if device.type != "cuda" or x.device.type != "cpu":
        return x.to(device)
    idx = device.index if device.index is not None else torch.cuda.current_device()
    copy = _COPY_STREAMS.get(idx)
    if copy is None:
        copy = _COPY_STREAMS[idx] = torch.cuda.Stream(device=idx)
    pinned = x.pin_memory()
    with torch.cuda.stream(copy):
        out = pinned.to(device, non_blocking=True)
    torch.cuda.current_stream(device).wait_stream(copy)
    out.record_stream(torch.cuda.current_stream(device))
    return out


def _prepare_chunk(
    encoder: Any, inputs: Tuple[Any, ...], keep: Optional[torch.Tensor], n_bad: int, bucket_rows: bool
) -> Tuple[Tuple[Any, ...], torch.Tensor, int, int, int]:
    """Stage the inputs, pad the batch axis to a pow2 bucket and build the
    ``valid`` mask. Returns ``(staged_inputs, valid, n_real_rows,
    n_raw_rows, bucket)``."""
    batched = _bucketing.batched_leaf_indices(list(inputs))
    if not batched:
        raise ValueError(
            "encode_stream needs array inputs sharing a leading batch axis;"
            f" got shapes {[tuple(getattr(x, 'shape', ())) for x in inputs]}"
        )
    device = encoder.device
    n = int(inputs[batched[0]].shape[0])
    bucket = _bucketing.next_pow2(n) if bucket_rows else n
    mult = encoder.batch_multiple()
    if bucket % mult:
        bucket = ((bucket + mult - 1) // mult) * mult
    staged = [_stage(x, device) for x in inputs]
    staged = _bucketing.pad_leaves(staged, batched, bucket - n)
    valid = torch.zeros((bucket,), dtype=torch.float32, device=device)
    if keep is None:
        valid[:n] = 1.0
    else:
        valid[:n] = keep.to(device=device, dtype=torch.float32)
    return tuple(staged), valid, n - n_bad, n, bucket


def encode_stream(
    encoder: Any,
    batches: Any,
    consumer: Callable,
    carry: Any,
    *,
    screen: Any = None,
    bucket_rows: bool = True,
    source: Optional[str] = None,
) -> Tuple[Any, StreamResult]:
    """Stream batches through fused encode+accumulate programs.

    Args:
        encoder: a :class:`~metrics_tpu_torch.encoders.runtime.ShardedEncoder`.
        batches: iterable of per-chunk input tuples (a bare array per chunk
            is treated as a 1-tuple): numpy arrays, host tensors or tensors
            already on the encoder's device.
        consumer: ``consumer(carry, features, valid) -> carry`` where
            ``valid`` is a float ``[bucket]`` row mask (0 for pad rows and
            health-masked rows). It runs inside the captured program, and
            it MUST be a stable object across calls: the program is keyed
            by its identity.
        carry: initial accumulation tree (e.g. a metric's streaming states).
        screen: the metric whose ``on_bad_input``/``health_screen`` policy
            screens raw inputs upstream of the encoder (None: no screening).
        bucket_rows: pad the batch axis to pow2 buckets (default) so ragged
            final chunks reuse the full chunk's program.
        source: the ``source`` of the chunks' ``encode`` events (default:
            the screening metric's class, else the encoder's name).

    Returns ``(final_carry, StreamResult)``.
    """
    label = source or (type(screen).__name__ if screen is not None else encoder.name)
    policy = getattr(screen, "on_bad_input", "propagate") if screen is not None else "propagate"
    nan_only = getattr(screen, "health_screen", "nonfinite") == "nan"
    result = StreamResult()
    for raw in _as_batches(batches):
        screened = _screen_batch(raw, policy, nan_only, screen, result)
        if screened is None:
            continue
        inputs, keep, n_bad = screened
        staged, valid, n_real, n_rows, bucket = _prepare_chunk(encoder, inputs, keep, n_bad, bucket_rows)
        carry = encoder.encode_into(consumer, carry, staged, valid)
        result.chunks += 1
        result.rows += n_real
        _runtime.count("stream_chunks")
        _runtime.count("rows_encoded", n_real)
        if bucket != n_rows:
            # bucketed = the batch axis was padded (bucket vs the raw row
            # count: a health-masked row is screening, not bucketing)
            _runtime.count("bucketed_dispatches")
        if _bus.enabled():
            _bus.emit("encode", source=label, encoder=encoder.name, rows=n_real, bucket=bucket, fused=True)
    return carry, result

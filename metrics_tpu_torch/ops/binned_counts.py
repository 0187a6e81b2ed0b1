"""Streaming binned counters behind the curve and calibration metrics
(counterpart of ``metrics_tpu/ops/binned_counts.py``).

* ``binned_counts``: ``(TP, FP, FN, TN)``, four ``[C, T]`` int64 counts of
  ``preds[n, c] >= thresholds[t]`` against ``target[n, c] > 0``, for
  ``BinnedPrecisionRecallCurve`` and its subclasses and ``AUROC(thresholds=)``.
  The compare runs in float64 when preds or thresholds are float64, else in
  float32 (bfloat16 and float16 widen exactly), as the JAX package's XLA
  composition promotes. A NaN pred is below every threshold; thresholds may
  come in any order and repeat.
* ``binned_calibration``: per-bin ``(count, conf_sum, acc_sum)`` over ``B``
  bins of ascending boundaries ``b``, for ``CalibrationError(streaming_bins=True)``:
  bin ``i`` holds ``b[i] < conf <= b[i+1]``, ``conf <= b[0]`` falls in no bin,
  and ``conf > b[B]`` and NaN land in the last bin. Counts are int64; the sums
  are float32, within 1e-5 relative of each other on the two paths (the
  kernel's float atomics add in no fixed order).

Both follow the XLA composition, which is what users of the JAX package run
(its Pallas kernels are off by default): the Pallas calibration body drops a
confidence above the last boundary or NaN, and lets one NaN spoil every
bin's sum; the Pallas threshold body narrows float64 preds to float32.

The CUDA kernels are in ``csrc/binned_counts.cu``; each has its plain
PyTorch version here, which the CPU path runs and the kernel is held
against on the card.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.ops import _build
from metrics_tpu_torch.ops import registry as _registry

Counts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _compare_dtype(preds: torch.Tensor, thresholds: torch.Tensor) -> torch.dtype:
    return torch.float64 if torch.float64 in (preds.dtype, thresholds.dtype) else torch.float32


def _binned_counts_eligible(preds: torch.Tensor, target: torch.Tensor, thresholds: torch.Tensor) -> Tuple[bool, str]:
    if preds.ndim != 2 or preds.shape != target.shape:
        return False, f"preds and target must be 2-D of one shape, got {tuple(preds.shape)} and {tuple(target.shape)}"
    if thresholds.ndim != 1 or thresholds.numel() < 1:
        return False, f"thresholds must be 1-D and not empty, got shape {tuple(thresholds.shape)}"
    if not (preds.is_floating_point() and thresholds.is_floating_point()):
        return False, f"preds and thresholds must be floating point, got {preds.dtype} and {thresholds.dtype}"
    if target.is_complex():
        return False, f"target must be real, got {target.dtype}"
    if not preds.device == target.device == thresholds.device:
        return False, f"preds on {preds.device}, target on {target.device}, thresholds on {thresholds.device}"
    return True, "ok"


def _binned_counts_plain(preds: torch.Tensor, target: torch.Tensor, thresholds: torch.Tensor) -> Counts:
    dtype = _compare_dtype(preds, thresholds)
    above = preds.to(dtype)[:, :, None] >= thresholds.to(dtype)[None, None, :]
    pos = (target > 0)[:, :, None]
    return (
        (above & pos).sum(0),
        (above & ~pos).sum(0),
        (~above & pos).sum(0),
        (~above & ~pos).sum(0),
    )


def _binned_counts_cuda(preds: torch.Tensor, target: torch.Tensor, thresholds: torch.Tensor) -> Counts:
    lib = _build.library()
    dtype = _compare_dtype(preds, thresholds)
    p = preds.to(dtype).contiguous()
    th = thresholds.to(dtype).contiguous()
    y = target.contiguous() if target.dtype == torch.int32 else (target > 0).to(torch.int32)
    n, c = p.shape
    t = th.shape[0]
    tp = torch.zeros((c, t), dtype=torch.int64, device=p.device)
    fp = torch.zeros((c, t), dtype=torch.int64, device=p.device)
    pos = torch.zeros((c,), dtype=torch.int64, device=p.device)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    entry = lib.mt_binned_counts_f64 if dtype == torch.float64 else lib.mt_binned_counts_f32
    err = entry(p.device.index, p.data_ptr(), y.data_ptr(), th.data_ptr(), n, c, t, tp.data_ptr(), fp.data_ptr(), pos.data_ptr(), stream)
    _build.check(lib, err, "binned_counts kernel")
    _registry.count_launch("binned_counts")
    # every row is below or above each threshold, positive or not
    return tp, fp, pos[:, None] - tp, (n - pos)[:, None] - fp


def binned_stat_counts(preds: torch.Tensor, target: torch.Tensor, thresholds: torch.Tensor) -> Counts:
    """``(TP, FP, FN, TN)``, each ``[C, T]`` int64, of ``preds``/``target``
    ``[N, C]`` against ``thresholds [T]``."""
    return _registry.dispatch("binned_counts", preds, target, thresholds)


def _binned_calibration_eligible(
    confidences: torch.Tensor, accuracies: torch.Tensor, bin_boundaries: torch.Tensor
) -> Tuple[bool, str]:
    if confidences.ndim != 1 or confidences.shape != accuracies.shape:
        return False, f"confidences and accuracies must be 1-D of one length, got {tuple(confidences.shape)} and {tuple(accuracies.shape)}"
    if bin_boundaries.ndim != 1 or bin_boundaries.numel() < 2:
        return False, f"bin_boundaries must be 1-D with at least 2 entries, got shape {tuple(bin_boundaries.shape)}"
    if not confidences.is_floating_point():
        return False, f"confidences must be floating point, got {confidences.dtype}"
    if not confidences.device == accuracies.device == bin_boundaries.device:
        return False, f"confidences on {confidences.device}, accuracies on {accuracies.device}, bin_boundaries on {bin_boundaries.device}"
    return True, "ok"


def _binned_calibration_plain(
    confidences: torch.Tensor, accuracies: torch.Tensor, bin_boundaries: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    conf = confidences.to(torch.float32)
    acc = accuracies.to(torch.float32)
    bins = bin_boundaries.numel() - 1
    # (b[i], b[i+1]]: searchsorted(side="left") counts the boundaries below conf
    idx = (torch.searchsorted(bin_boundaries.to(torch.float32), conf, side="left") - 1).clamp(max=bins - 1)
    idx = torch.where(torch.isnan(conf), bins - 1, idx)  # NaN: the last bin, whatever searchsorted made of it
    idx = torch.where(idx < 0, bins, idx)  # conf <= b[0]: a spare bin that is cut off
    count = torch.zeros(bins + 1, dtype=torch.int64, device=conf.device).index_add_(0, idx, torch.ones_like(idx))
    conf_sum = torch.zeros(bins + 1, dtype=torch.float32, device=conf.device).index_add_(0, idx, conf)
    acc_sum = torch.zeros(bins + 1, dtype=torch.float32, device=conf.device).index_add_(0, idx, acc)
    return count[:bins], conf_sum[:bins], acc_sum[:bins]


def _binned_calibration_cuda(
    confidences: torch.Tensor, accuracies: torch.Tensor, bin_boundaries: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    lib = _build.library()
    conf = confidences.to(torch.float32).contiguous()
    acc = accuracies.to(torch.float32).contiguous()
    bounds = bin_boundaries.to(torch.float32).contiguous()
    bins = bounds.numel() - 1
    count = torch.zeros(bins, dtype=torch.int64, device=conf.device)
    conf_sum = torch.zeros(bins, dtype=torch.float32, device=conf.device)
    acc_sum = torch.zeros(bins, dtype=torch.float32, device=conf.device)
    stream = torch.cuda.current_stream(conf.device).cuda_stream
    err = lib.mt_binned_calibration(
        conf.device.index, conf.data_ptr(), acc.data_ptr(), bounds.data_ptr(), conf.numel(), bins,
        count.data_ptr(), conf_sum.data_ptr(), acc_sum.data_ptr(), stream,
    )
    _build.check(lib, err, "binned_calibration kernel")
    _registry.count_launch("binned_calibration")
    return count, conf_sum, acc_sum


def binned_calibration_counts(
    confidences: torch.Tensor, accuracies: torch.Tensor, bin_boundaries: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-bin ``(count, conf_sum, acc_sum)`` (int64, float32, float32) over
    the ``(b[i], b[i+1]]`` bins of ascending ``bin_boundaries``."""
    return _registry.dispatch("binned_calibration", confidences, accuracies, bin_boundaries)


_registry.register(
    _registry.KernelOp(
        name="binned_counts",
        kernel=_binned_counts_cuda,
        plain=_binned_counts_plain,
        eligible=_binned_counts_eligible,
    )
)
_registry.register(
    _registry.KernelOp(
        name="binned_calibration",
        kernel=_binned_calibration_cuda,
        plain=_binned_calibration_plain,
        eligible=_binned_calibration_eligible,
    )
)

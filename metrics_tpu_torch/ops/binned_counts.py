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
  kernel adds in float32 in a fixed order of its own, so its sums are the
  same from launch to launch; the plain version adds in float64).

Both follow the XLA composition, which is what users of the JAX package run
(its Pallas kernels are off by default): the Pallas calibration body drops a
confidence above the last boundary or NaN, and lets one NaN spoil every
bin's sum; the Pallas threshold body narrows float64 preds to float32.

The CUDA kernels are in ``csrc/binned_counts.cu``; each has its plain
PyTorch version here, which the CPU path runs and the kernel is held
against on the card.

``binned_counts`` replaces ``_binned_counts_kernel``
(``metrics_tpu/ops/binned_counts.py:51``). Its bound is bytes (1.72 us at
[8192, 80], T = 200, on an H100 at 3.35 TB/s): with the thresholds sorted,
``p >= th[t]`` exactly when ``#{s <= p} > #{th < th[t]}``, so each element
needs one binary search (``N*C*ceil(log2(T+1))`` compares, not the first
design's ``N*C*T``) and the counts are suffix sums of a per-class histogram
over the ``T + 1`` positions. The kernel builds that histogram per block
in shared memory from 16-byte loads, guessing each bin as if the grid were
even and searching only where the guess fails; where the rows fit 16
blocks per class tile (both of the paths' shapes) it runs as clusters of
those blocks, which sum their histograms through distributed shared memory
and write all four outputs in the same launch. Otherwise the blocks store
partial rows and a finishing kernel sums them. The wrapper makes one
``torch.empty`` (outputs and scratch). Past about 19,000 thresholds
(14,000 for float64) a class's histogram no longer fits a block, and the
blocks add to one 64-bit histogram in device memory instead (a memset, a
threshold-ranking kernel, the two kernels).

``binned_calibration`` replaces ``_binned_calibration_kernel``
(``metrics_tpu/ops/binned_counts.py:172``). Its bound is bytes (two float32
reads per confidence). Up to 64 bins the kernel gives each thread private
words in shared memory for every bin (no atomics, and the same time
however the confidences fall), folds them in a fixed order and writes the
outputs in the same launch, as one cluster up to 32,768 confidences and as
a cooperative grid over every SM past that; :func:`_calibration_route`
picks the kernel's instance (16, 32 or 64 bins), the route and the load
width. Past 64 bins the first design's shared-atomics kernel runs, after a
memset of the outputs.
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
    # the four outputs and the kernels' scratch in one allocation; the C entry
    # writes every output element and zeroes what scratch it needs itself
    scratch_bytes = lib.mt_binned_counts_scratch_bytes(n, c, t, p.element_size())
    buf = torch.empty(4 * c * t + (scratch_bytes + 7) // 8, dtype=torch.int64, device=p.device)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    entry = lib.mt_binned_counts_f64 if dtype == torch.float64 else lib.mt_binned_counts_f32
    err = entry(
        p.device.index, p.data_ptr(), y.data_ptr(), th.data_ptr(), n, c, t,
        buf.data_ptr(), buf.data_ptr() + 8 * 4 * c * t, scratch_bytes, stream,
    )
    _build.check(lib, err, "binned_counts kernel")
    _registry.count_launch("binned_counts")
    tp, fp, fn, tn = buf[: 4 * c * t].view(4, c, t)
    return tp, fp, fn, tn


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
    # float64 sums, rounded once: a float32 index_add_ adds each bin's values
    # one after another, which drifts by 1e-5 relative and more once a bin
    # holds some 10^5 values (on the card its atomics also add in no fixed order)
    conf_sum = torch.zeros(bins + 1, dtype=torch.float64, device=conf.device).index_add_(0, idx, conf.double())
    acc_sum = torch.zeros(bins + 1, dtype=torch.float64, device=conf.device).index_add_(0, idx, acc.double())
    return count[:bins], conf_sum[:bins].float(), acc_sum[:bins].float()


#: Instances of the private-bins kernel: the bins ``K`` its warp fold takes.
_CAL_REGS = (16, 32, 64)
#: Past this many confidences (a batch of 8 for each thread of 16 blocks)
#: the private-bins kernel runs as a cooperative grid over every SM, not as
#: one cluster.
_CAL_CLUSTER_MAX = 32_768
_CAL_ROUTES = {"atomics": 0, "cluster": 1, "grid": 2}


def _calibration_route(n: int, bins: int, conf_ptr: int, acc_ptr: int) -> Tuple[str, int, bool]:
    """``(route, K, 16-byte loads)`` of the calibration kernel for ``n``
    float32 confidences in ``bins`` bins at these addresses: the private-bins
    kernel with the smallest ``K`` that holds ``bins``, as one cluster up to
    32,768 confidences and as a cooperative grid past that; past 64 bins (or
    2**31 confidences) the shared-atomics kernel."""
    regs = next((k for k in _CAL_REGS if bins <= k), 0)
    if not regs or n >= 1 << 31:
        return "atomics", 0, False
    route = "cluster" if n <= _CAL_CLUSTER_MAX else "grid"
    return route, regs, conf_ptr % 16 == 0 and acc_ptr % 16 == 0


def _binned_calibration_cuda(
    confidences: torch.Tensor, accuracies: torch.Tensor, bin_boundaries: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    lib = _build.library()
    conf = confidences.to(torch.float32).contiguous()
    acc = accuracies.to(torch.float32).contiguous()
    bounds = bin_boundaries.to(torch.float32).contiguous()
    bins, n = bounds.numel() - 1, conf.numel()
    route, regs, vec = _calibration_route(n, bins, conf.data_ptr(), acc.data_ptr())
    dev = conf.device.index
    scratch = lib.mt_binned_calibration_scratch_bytes(dev, _CAL_ROUTES[route], regs, bins)
    if scratch < 0:
        raise RuntimeError(f"binned_calibration: the occupancy query for device {dev} failed")
    # count (int64), conf_sum and acc_sum (float32) and the scratch in one
    # allocation; the C entry writes every output element
    buf = torch.empty(16 * bins + scratch, dtype=torch.uint8, device=conf.device)
    stream = torch.cuda.current_stream(conf.device).cuda_stream
    err = lib.mt_binned_calibration(
        dev, conf.data_ptr(), acc.data_ptr(), bounds.data_ptr(), n, bins, _CAL_ROUTES[route], regs, int(vec),
        buf.data_ptr(), buf.data_ptr() + 16 * bins, scratch, stream,
    )
    _build.check(lib, err, "binned_calibration kernel")
    _registry.count_launch("binned_calibration")
    return buf[: 8 * bins].view(torch.int64), buf[8 * bins : 12 * bins].view(torch.float32), buf[12 * bins : 16 * bins].view(torch.float32)


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

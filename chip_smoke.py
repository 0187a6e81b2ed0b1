#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (``metrics_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Device and build: the card's name and power limit; the CUDA kernels are
   built from ``metrics_tpu_torch/csrc`` with ``nvcc``.
2. Every kernel against its plain PyTorch version on the card, bit for bit,
   at the main path's shapes, on a ragged tail and on edge-case rows; then
   timed with CUDA events beside its bound, its plain version and (where one
   exists) a single PyTorch call computing the same function.
3. The main path: a ``MetricCollection`` of top-1 and top-5 accuracy,
   macro-F1 and the confusion matrix streams ImageNet-1k validation at full
   size (50,000 samples, 1000 classes, batches of 8192) through ``forward``,
   then ``compute()``; held against a numpy oracle, with the kernel launch
   counts of that run.
4. Multilabel: ``ConfusionMatrix(multilabel=True)`` over MS-COCO 2014 val
   size (40,504 samples, 80 labels), held against a numpy oracle.
5. The curve and calibration path, each phase held against a numpy float64
   oracle with its launch counts:
   a. MS-COCO 2014 val multilabel curves: ``BinnedAveragePrecision`` and
      ``BinnedRecallAtFixedPrecision`` (80 labels, 200 thresholds) in one
      ``MetricCollection``;
   b. ImageNet-1k val calibration: ``CalibrationError(n_bins=15)``, streaming
      and buffered, over the softmax of phase 3's logits at temperature 1/4;
   c. binary AUROC at a CTR eval pass's scale (4,194,304 samples in batches
      of 65,536): ``AUROC(thresholds=200)`` beside the exact ``AUROC()``.
6. A profile: each kernel's device time per launch, and the device busy
   share, host syncs and top device ops of batches of each path.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the per-kernel JSON record. Any failure raises and exits non-zero. Without
CUDA the script exits 2 and prints no result.
"""
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

SEED = 0
BATCH = 8192
IMAGENET_VAL = (50_000, 1000)  # ILSVRC2012 val: samples, classes
COCO_VAL = (40_504, 80)  # MS-COCO 2014 val: images, labels
TOP_K = 5
RAGGED = 848  # 50,000 - 6 * 8192
COCO_RAGGED = 7736  # 40,504 - 4 * 8192
THRESHOLDS = 200  # tf.keras.metrics.AUC's default num_thresholds
CAL_BINS = 15  # CalibrationError's default (Guo et al. 2017)
# softmax temperature 1/4 on the ImageNet logits: top-1 confidences spread over
# the 15 bins, their mean (about 0.56) above top-1 accuracy (about 0.41), as an
# uncalibrated classifier's are (Guo et al. 2017)
CAL_LOGIT_SCALE = 4.0
MIN_PRECISION = 0.9
CTR_EVAL = (4_194_304, 65_536)  # binary samples, batch

# NVIDIA H100 SXM data sheet: the HBM rate, and the CUDA cores' instruction
# rate (132 SMs x 128 lanes x 1.98 GHz; the sheet's 67 TFLOP/s float32 counts
# an FMA as two). No tensor-core type applies to these integer and compare
# workloads, whose every compare or add is one instruction.
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 33.5e12


def _log(msg: str) -> None:
    print(msg, flush=True)


def _bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / CUDA_CORE_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _cuda_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls, by CUDA
    events (so it includes the host's launch cost when that is the longer)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _max_abs_err(torch, name: str, got, want) -> float:
    """Max |kernel - plain|; raises unless the two are bit-identical."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: kernel gives {got.dtype}{tuple(got.shape)}, plain {want.dtype}{tuple(want.shape)}")
    err = (got.double() - want.double()).abs().max().item() if got.numel() else 0.0
    if err != 0.0 or not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel and plain version differ (max abs err {err})")
    return err


def _topk_edge_rows(rng: np.random.Generator, rows: int, c: int) -> np.ndarray:
    """NaN, +-inf, runs of ties, mixed -0.0/0.0 and rows with fewer than k finite values."""
    specials = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.0, -1.0, 0.5], np.float32)
    x = np.empty((rows, c), np.float32)
    for r in range(rows):
        kind = r % 6
        if kind == 0:  # runs of ties
            x[r] = rng.integers(0, 3, c)
        elif kind == 1:  # scattered NaN and +inf in normal noise
            x[r] = rng.standard_normal(c)
            x[r, rng.choice(c, 7, replace=False)] = np.nan
            x[r, rng.choice(c, 3, replace=False)] = np.inf
        elif kind == 2:  # fewer than k finite values
            x[r] = -np.inf
            x[r, rng.choice(c, r % 4, replace=False)] = rng.standard_normal(r % 4)
        elif kind == 3:  # signed zeros below a few negatives
            x[r] = np.where(rng.random(c) < 0.5, -0.0, 0.0)
            x[r, rng.choice(c, 5, replace=False)] = -1.0
        elif kind == 4:  # all NaN
            x[r] = np.nan
        else:
            x[r] = rng.choice(specials, c)
    return x


def check_and_time_kernels(torch, rng):
    from metrics_tpu_torch.ops import confusion_counts as cc
    from metrics_tpu_torch.ops import select_topk as st

    dev = torch.device("cuda")
    n, c = BATCH, IMAGENET_VAL[1]
    ml_c = COCO_VAL[1]
    records = {}

    # confusion_counts: main-path shape, ragged tail, out-of-range indices
    errs = []
    preds = torch.from_numpy(rng.integers(0, c, n)).to(dev)
    target = torch.from_numpy(rng.integers(0, c, n)).to(dev)
    bad = torch.from_numpy(rng.integers(-3, c + 3, n)).to(dev)
    for tag, (p, t) in {
        "main": (preds, target),
        "ragged": (preds[:RAGGED], target[:RAGGED]),
        "out_of_range": (bad, target),
    }.items():
        errs.append(_max_abs_err(torch, f"confusion_counts[{tag}]", cc._confusion_counts_cuda(p, t, c), cc._confusion_counts_plain(p, t, c)))
    ms = _cuda_ms(torch, lambda: cc._confusion_counts_cuda(preds, target, c))
    plain_ms = _cuda_ms(torch, lambda: cc._confusion_counts_plain(preds, target, c))
    library_ms = _cuda_ms(torch, lambda: torch.bincount(target * c + preds, minlength=c * c))
    bound_ms, bound_by = _bound_ms(2 * n * 8 + c * c * 8, 5 * n)
    records["confusion_counts"] = dict(
        source="metrics_tpu_torch/csrc/confusion_counts.cu",
        replaces="metrics_tpu/ops/confusion_counts.py:44",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        shape=f"N={n}, C={c}",
    )

    # multilabel_counts: main-path shape (COCO width), ragged tail
    errs = []
    mp = torch.from_numpy(rng.integers(0, 2, (n, ml_c), dtype=np.int32)).to(dev)
    mt_ = torch.from_numpy(rng.integers(0, 2, (n, ml_c), dtype=np.int32)).to(dev)
    for tag, (p, t) in {"main": (mp, mt_), "ragged": (mp[:RAGGED], mt_[:RAGGED])}.items():
        errs.append(_max_abs_err(torch, f"multilabel_counts[{tag}]", cc._multilabel_counts_cuda(p, t), cc._multilabel_counts_plain(p, t)))
    ms = _cuda_ms(torch, lambda: cc._multilabel_counts_cuda(mp, mt_))
    plain_ms = _cuda_ms(torch, lambda: cc._multilabel_counts_plain(mp, mt_))
    bound_ms, bound_by = _bound_ms(2 * n * ml_c * 4 + ml_c * 4 * 8, 3 * n * ml_c)
    records["multilabel_counts"] = dict(
        source="metrics_tpu_torch/csrc/confusion_counts.cu",
        replaces="metrics_tpu/ops/confusion_counts.py:109",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        shape=f"N={n}, C={ml_c}",
    )

    # select_topk: main-path shape, ragged tail, edge rows, half inputs, a
    # row too wide for the default 48 KB of shared memory
    errs = []
    x = torch.from_numpy(rng.standard_normal((n, c)).astype(np.float32)).to(dev)
    edge = torch.from_numpy(_topk_edge_rows(rng, 600, c)).to(dev)
    wide = torch.from_numpy(_topk_edge_rows(rng, 48, 20_000)).to(dev)
    x64 = x.double() + torch.from_numpy(rng.standard_normal((n, c)) * 1e-9).to(dev)  # ties only float64 separates
    cases = {"main": (x, TOP_K), "ragged": (x[:RAGGED], TOP_K), "bf16": (x.bfloat16(), TOP_K), "f16": (x.half(), 3)}
    cases.update({"f64": (x64, TOP_K), "f64_edge": (edge.double(), 5), "f64_wide": (wide.double(), 7)})
    cases.update({f"edge_k{k}": (edge, k) for k in (2, 5, 64)})
    cases["wide_k7"] = (wide, 7)
    for tag, (v, k) in cases.items():
        errs.append(_max_abs_err(torch, f"select_topk[{tag}]", st._topk_mask_cuda(v, k), st._topk_mask_plain(v, k)))
    ms = _cuda_ms(torch, lambda: st._topk_mask_cuda(x, TOP_K))
    plain_ms = _cuda_ms(torch, lambda: st._topk_mask_plain(x, TOP_K), iters=10)
    library_ms = _cuda_ms(
        torch, lambda: torch.zeros(x.shape, dtype=torch.int32, device=dev).scatter_(1, torch.topk(x, TOP_K).indices, 1)
    )
    bound_ms, bound_by = _bound_ms(n * c * 4 + n * c * 4, n * c * TOP_K)
    ms64 = _cuda_ms(torch, lambda: st._topk_mask_cuda(x64, TOP_K))
    plain_ms64 = _cuda_ms(torch, lambda: st._topk_mask_plain(x64, TOP_K), iters=10)
    bound64, _ = _bound_ms(n * c * 8 + n * c * 4, n * c * TOP_K)
    _log(f"kernel select_topk ([{n}, {c}] f64, k={TOP_K}): ms={ms64:.4f} plain_ms={plain_ms64:.4f} bound_ms={bound64:.4f}")
    records["select_topk"] = dict(
        source="metrics_tpu_torch/csrc/select_topk.cu",
        replaces="metrics_tpu/ops/select_topk.py:38",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        shape=f"[{n}, {c}] f32, k={TOP_K}",
    )
    for name, rec in records.items():
        lib = "n/a" if rec["library_ms"] is None else f"{rec['library_ms']:.4f}"
        _log(
            f"kernel {name} ({rec['shape']}): bit-identical to plain on all cases; ms={rec['ms']:.4f}"
            f" plain_ms={rec['plain_ms']:.4f} library_ms={lib} bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']})"
        )
    calls = {
        "confusion_counts": lambda: cc._confusion_counts_cuda(preds, target, c),
        "multilabel_counts": lambda: cc._multilabel_counts_cuda(mp, mt_),
        "select_topk": lambda: st._topk_mask_cuda(x, TOP_K),
    }
    return records, calls


def _binned_counts_cases(torch, rng, dev):
    """``name -> (preds, target, thresholds)`` at the curve path's shapes and on edge inputs."""
    n, c = BATCH, COCO_VAL[1]
    grid = torch.linspace(0, 1, THRESHOLDS, device=dev)
    probs = torch.from_numpy(rng.random((n, c), dtype=np.float32)).to(dev)
    labels = torch.from_numpy((rng.random((n, c)) < 3 / c).astype(np.int32)).to(dev)
    ctr = torch.from_numpy(rng.random((CTR_EVAL[1], 1), dtype=np.float32)).to(dev)
    ctr_labels = torch.from_numpy((rng.random((CTR_EVAL[1], 1)) < 0.25).astype(np.int32)).to(dev)
    with_nan = probs.clone()
    with_nan[torch.from_numpy(rng.random((n, c)) < 0.01).to(dev)] = float("nan")
    on_grid = grid[torch.from_numpy(rng.integers(0, THRESHOLDS, (n, c))).to(dev)]  # preds exactly on thresholds
    shuffled = torch.cat([grid[torch.randperm(THRESHOLDS, device=dev)], grid[:17], torch.tensor([-np.inf, np.inf, np.nan], device=dev)])
    return {
        "main": (probs, labels, grid),
        "ragged": (probs[:COCO_RAGGED], labels[:COCO_RAGGED], grid),
        "ctr_shape": (ctr, ctr_labels, grid),
        "nan_preds": (with_nan, labels, grid),
        "on_grid": (on_grid, labels, grid),
        "unsorted_repeated": (on_grid, labels, shuffled),
        "bf16": (on_grid.bfloat16(), labels, grid),
        "f16": (probs.half(), labels, grid),
        "f64": (on_grid.double() + 1e-12, labels, grid),  # above a grid point only in float64
        "f64_thresholds": (probs, labels, grid.double()),
        "all_positive": (probs, torch.ones_like(labels), grid),
        "all_negative": (probs, torch.zeros_like(labels), grid),
        "int64_target": (probs, labels.long() * 3 - 1, grid),  # positive means > 0
    }


def _top1_calibration(torch, logits, target):
    """The calibration phase's softmax, and its top-1 confidences and correctness."""
    probs = torch.softmax(logits * CAL_LOGIT_SCALE, dim=1)
    return probs, probs.amax(dim=1), (probs.argmax(dim=1) == target).float()


def _calibration_cases(torch, rng, dev):
    """``name -> (confidences, accuracies, boundaries)`` at the calibration path's shapes and on edge inputs."""
    n = BATCH
    logits, target = _imagenet_stream(rng, n)  # one batch of what the calibration phase feeds the kernel
    _, conf, acc = _top1_calibration(torch, torch.from_numpy(logits).to(dev), torch.from_numpy(target).to(dev))
    b15 = torch.linspace(0, 1, CAL_BINS + 1, device=dev)
    edge = conf.clone()
    pick = torch.from_numpy(rng.integers(0, CAL_BINS + 1, n)).to(dev)
    specials = torch.tensor([0.0, 1.0, 1.5, np.inf, -0.5, -np.inf, np.nan], device=dev)
    kind = torch.from_numpy(rng.integers(0, 3, n)).to(dev)
    edge = torch.where(kind == 0, b15[pick], edge)  # exactly on float32 boundaries
    edge = torch.where(kind == 1, specials[torch.from_numpy(rng.integers(0, len(specials), n)).to(dev)], edge)
    return {
        "main_b15": (conf, acc, b15),
        "b5000": (conf, acc, torch.linspace(0, 1, 5001, device=dev)),
        "ragged": (conf[:RAGGED], acc[:RAGGED], b15),
        "edge_b15": (edge, acc, b15),
        "edge_b5000": (edge, acc, torch.linspace(0, 1, 5001, device=dev)),
        "b20000_global_atomics": (edge, acc, torch.linspace(0, 1, 20001, device=dev)),
        "imagenet_size": (torch.from_numpy(rng.random(IMAGENET_VAL[0], dtype=np.float32)).to(dev), torch.ones(IMAGENET_VAL[0], device=dev), b15),
    }


def _sums_err(torch, name: str, got, want) -> float:
    """Max |kernel - plain| of a float32 sum; raises beyond 1e-5 relative (NaN
    where both are NaN): the kernel's float atomics add in no fixed order."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: kernel gives {got.dtype}{tuple(got.shape)}, plain {want.dtype}{tuple(want.shape)}")
    if not torch.allclose(got, want, rtol=1e-5, atol=0.0, equal_nan=True):
        raise AssertionError(f"{name}: kernel and plain sums differ beyond 1e-5 relative")
    both = ~(torch.isnan(got) & torch.isnan(want)) & ~(torch.isinf(got) & (got == want))
    return (got[both].double() - want[both].double()).abs().max().item() if both.any() else 0.0


def check_and_time_binned(torch, rng):
    from metrics_tpu_torch.ops import binned_counts as bc

    dev = torch.device("cuda")
    records = {}
    cases = _binned_counts_cases(torch, rng, dev)
    errs = []
    for tag, args in cases.items():
        for name, got, want in zip(("tp", "fp", "fn", "tn"), bc._binned_counts_cuda(*args), bc._binned_counts_plain(*args)):
            errs.append(_max_abs_err(torch, f"binned_counts[{tag}].{name}", got, want))
    n, c = cases["main"][0].shape
    main = cases["main"]
    bound_ms, bound_by = _bound_ms(2 * n * c * 4 + THRESHOLDS * 4 + 4 * c * THRESHOLDS * 8, n * c * THRESHOLDS)
    records["binned_counts"] = dict(
        source="metrics_tpu_torch/csrc/binned_counts.cu",
        replaces="metrics_tpu/ops/binned_counts.py:51",
        max_abs_err=max(errs), ms=_cuda_ms(torch, lambda: bc._binned_counts_cuda(*main)),
        plain_ms=_cuda_ms(torch, lambda: bc._binned_counts_plain(*main), iters=10),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None, shape=f"[{n}, {c}] f32, T={THRESHOLDS}",
    )
    ctr = cases["ctr_shape"]
    ctr_bound, ctr_by = _bound_ms(2 * CTR_EVAL[1] * 4 + THRESHOLDS * 4 + 4 * THRESHOLDS * 8, CTR_EVAL[1] * THRESHOLDS)
    _log(
        f"kernel binned_counts ([{CTR_EVAL[1]}, 1] f32, T={THRESHOLDS}): ms={_cuda_ms(torch, lambda: bc._binned_counts_cuda(*ctr)):.4f}"
        f" plain_ms={_cuda_ms(torch, lambda: bc._binned_counts_plain(*ctr), iters=10):.4f} bound_ms={ctr_bound:.4f} ({ctr_by})"
    )

    errs = []
    cal_cases = _calibration_cases(torch, rng, dev)
    for tag, args in cal_cases.items():
        got, want = bc._binned_calibration_cuda(*args), bc._binned_calibration_plain(*args)
        _max_abs_err(torch, f"binned_calibration[{tag}].count", got[0], want[0])
        errs += [_sums_err(torch, f"binned_calibration[{tag}].{name}", g, w) for name, g, w in zip(("conf_sum", "acc_sum"), got[1:], want[1:])]
    for tag in ("main_b15", "b5000"):
        conf, acc, bounds = cal_cases[tag]
        bins = bounds.numel() - 1
        bound_ms, bound_by = _bound_ms(2 * conf.numel() * 4 + (bins + 1) * 4 + bins * 16, conf.numel() * np.log2(bins + 1))
        rec = dict(
            source="metrics_tpu_torch/csrc/binned_counts.cu",
            replaces="metrics_tpu/ops/binned_counts.py:172",
            max_abs_err=max(errs), ms=_cuda_ms(torch, lambda: bc._binned_calibration_cuda(conf, acc, bounds)),
            plain_ms=_cuda_ms(torch, lambda: bc._binned_calibration_plain(conf, acc, bounds)),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None, shape=f"N={conf.numel()}, B={bins}",
        )
        if tag == "main_b15":
            records["binned_calibration"] = rec
        else:
            _log(f"kernel binned_calibration ({rec['shape']}): ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} bound_ms={rec['bound_ms']:.4f} ({bound_by})")
    for name, rec in records.items():
        _log(
            f"kernel {name} ({rec['shape']}): matches plain on all {len(cases) if name == 'binned_counts' else len(cal_cases)} cases"
            f" (max abs err {rec['max_abs_err']:.3g}); ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f}"
            f" library_ms=none (no single call) bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']})"
        )
    conf, acc, b15 = cal_cases["main_b15"]
    calls = {
        "binned_counts": lambda: bc._binned_counts_cuda(*main),
        "binned_calibration": lambda: bc._binned_calibration_cuda(conf, acc, b15),
    }
    return records, calls


def _imagenet_stream(rng, n: int = IMAGENET_VAL[0]):
    """Seeded ImageNet-1k logits with a signal on the target class (val size by default)."""
    c = IMAGENET_VAL[1]
    target = rng.integers(0, c, n)
    logits = rng.standard_normal((n, c), dtype=np.float32)
    logits[np.arange(n), target] += np.float32(3.0)
    return logits, target


def _numpy_oracle(logits: np.ndarray, target: np.ndarray, c: int):
    n = len(target)
    rows = np.arange(n)
    t_score = logits[rows, target][:, None]
    cols = np.arange(c)[None, :]
    rank = (logits > t_score).sum(1) + ((logits == t_score) & (cols < target[:, None])).sum(1)
    pred1 = logits.argmax(1)
    confmat = np.zeros((c, c), np.int64)
    np.add.at(confmat, (target, pred1), 1)
    tp = np.diag(confmat).astype(np.float64)
    fp = confmat.sum(0) - tp
    fn = confmat.sum(1) - tp
    precision = np.divide(tp, tp + fp, out=np.zeros(c), where=(tp + fp) > 0)
    recall = np.divide(tp, tp + fn, out=np.zeros(c), where=(tp + fn) > 0)
    f1 = np.divide(2 * precision * recall, precision + recall, out=np.zeros(c), where=(precision + recall) > 0)
    present = (tp + fp + fn) > 0
    return {
        "top1": (pred1 == target).mean(),
        "top5": (rank < TOP_K).mean(),
        "f1": f1[present].mean(),
        "confmat": confmat,
    }


def _check_result(name: str, got, want) -> None:
    got = got.cpu().numpy()
    if np.asarray(want).dtype.kind in "iu":
        if not np.array_equal(got, want):
            raise AssertionError(f"{name}: counts differ from the numpy oracle")
    elif not np.isfinite(got).all() or abs(float(got) - float(want)) > 1e-6 * abs(float(want)):
        raise AssertionError(f"{name}: {float(got)!r} vs numpy oracle {float(want)!r} (rtol 1e-6)")


def _batches(total: int):
    return [(s, min(s + BATCH, total)) for s in range(0, total, BATCH)]


def run_main_path(torch, mt, rng):
    n, c = IMAGENET_VAL
    logits_np, target_np = _imagenet_stream(rng)
    oracle = _numpy_oracle(logits_np, target_np, c)
    logits = torch.from_numpy(logits_np).cuda()
    target = torch.from_numpy(target_np).cuda()
    mc = mt.MetricCollection(
        {
            "top1": mt.Accuracy(num_classes=c),
            "top5": mt.Accuracy(num_classes=c, top_k=TOP_K),
            "f1": mt.F1Score(num_classes=c, average="macro"),
            "confmat": mt.ConfusionMatrix(num_classes=c),
        }
    )
    batches = _batches(n)
    torch.cuda.synchronize()
    mt.reset_kernel_stats()
    t0 = time.perf_counter()
    for s, e in batches:
        mc(logits[s:e], target[s:e])
    result = mc.compute()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    stats = mt.kernel_stats()
    for key, want in oracle.items():
        _check_result(f"imagenet {key}", result[key], want)
    for op in ("confusion_counts", "select_topk"):
        if stats[op]["launches"] != len(batches):
            raise AssertionError(f"{op}: {stats[op]['launches']} launches for {len(batches)} batches")
    if any(rec["plain_calls"] for rec in stats.values()):
        raise AssertionError(f"a plain version ran on the main path: {stats}")
    updates = {k: m._update_count for k, m in mc.items()}
    _log(
        f"main path: ImageNet-1k val, {n} samples x {c} classes in {len(batches)} batches: matches the numpy oracle"
        f" (top1={float(result['top1']):.6f} top5={float(result['top5']):.6f} macro_f1={float(result['f1']):.6f});"
        f" {n / seconds:.0f} samples/s ({seconds * 1e3 / len(batches):.2f} ms/batch, first batch included);"
        f" updates per metric {updates}; kernel_stats {stats}"
    )
    return stats, mc, logits, target


def run_multilabel(torch, mt, rng):
    n, c = COCO_VAL
    probs_np = rng.random((n, c), dtype=np.float32)
    target_np = (rng.random((n, c)) < 0.05).astype(np.int64)  # about 3 labels per COCO image
    p_np = (probs_np >= 0.5).astype(np.int64)
    oracle = np.stack(
        [
            ((1 - p_np) * (1 - target_np)).sum(0),
            (p_np * (1 - target_np)).sum(0),
            ((1 - p_np) * target_np).sum(0),
            (p_np * target_np).sum(0),
        ],
        axis=-1,
    ).reshape(c, 2, 2)
    probs, target = torch.from_numpy(probs_np).cuda(), torch.from_numpy(target_np).cuda()
    cm = mt.ConfusionMatrix(num_classes=c, multilabel=True)
    batches = _batches(n)
    torch.cuda.synchronize()
    mt.reset_kernel_stats()
    for s, e in batches:
        cm(probs[s:e], target[s:e])
    result = cm.compute()
    stats = mt.kernel_stats()
    _check_result("coco multilabel confmat", result, oracle)
    if stats["multilabel_counts"]["launches"] != len(batches) or any(r["plain_calls"] for r in stats.values()):
        raise AssertionError(f"multilabel path: {stats} for {len(batches)} batches")
    _log(f"multilabel: MS-COCO 2014 val, {n} samples x {c} labels in {len(batches)} batches: matches the numpy oracle; kernel_stats {stats}")
    return stats


def _reset_stats(torch, mt):
    torch.cuda.synchronize()
    mt.reset_kernel_stats()
    return time.perf_counter()


def _read_stats(torch, mt, t0: float, expect: dict):
    """Seconds since ``t0``, and the kernel stats, which must show exactly
    ``expect`` launches per op and no plain call."""
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    stats = mt.kernel_stats()
    got = {op: stats[op]["launches"] for op in expect}
    if got != expect or any(rec["plain_calls"] for rec in stats.values()):
        raise AssertionError(f"launches {got}, expected {expect}; kernel_stats {stats}")
    return seconds, stats


def _close(name: str, got, want, atol: float = 0.0, rtol: float = 0.0) -> None:
    got = np.asarray(got.cpu().numpy() if hasattr(got, "cpu") else got, dtype=np.float64)
    if got.shape != np.shape(want) or not np.isfinite(got).all() or not np.allclose(got, want, rtol=rtol, atol=atol):
        err = np.abs(got - want).max() if got.shape == np.shape(want) else "shape"
        raise AssertionError(f"{name}: differs from the numpy oracle (max abs err {err}, atol {atol}, rtol {rtol})")


def _threshold_counts(scores: np.ndarray, positive: np.ndarray, ths: np.ndarray):
    """``(tp, fp, fn)`` of ``scores >= th`` per threshold, by binary search over sorted scores (O(N log N))."""
    pos = np.sort(scores[positive])
    neg = np.sort(scores[~positive])
    tp = len(pos) - np.searchsorted(pos, ths, side="left")
    fp = len(neg) - np.searchsorted(neg, ths, side="left")
    return tp, fp, len(pos) - tp


def _coco_curve_oracle(probs: np.ndarray, target: np.ndarray, ths: np.ndarray):
    """Per-label average precision and recall at precision >= MIN_PRECISION
    (with its threshold) over the binned curve, in float64."""
    eps = 1e-6  # METRIC_EPS
    counts = [_threshold_counts(probs[:, k], target[:, k] == 1, ths) for k in range(probs.shape[1])]
    tp, fp, fn = (np.stack([cnt[i] for cnt in counts]).astype(np.float64) for i in range(3))
    precision = np.concatenate([(tp + eps) / (tp + fp + eps), np.ones((len(tp), 1))], axis=1)
    recall = np.concatenate([tp / (tp + fn + eps), np.zeros((len(tp), 1))], axis=1)
    ap = -np.sum((recall[:, 1:] - recall[:, :-1]) * precision[:, :-1], axis=1)
    r_at_p, th_at_p = [], []
    for p, r in zip(precision[:, :-1], recall[:, :-1]):
        ok = p >= MIN_PRECISION
        best = max(zip(r[ok], p[ok], ths[ok])) if ok.any() else (0.0, 0.0, 0.0)
        r_at_p.append(best[0])
        th_at_p.append(1e6 if best[0] == 0.0 else best[2])
    return (tp, fp, fn), ap, np.array(r_at_p), np.array(th_at_p)


def run_coco_curves(torch, mt, rng):
    """MS-COCO 2014 val multilabel curves through the binned family."""
    n, c = COCO_VAL
    target_np = (rng.random((n, c)) < 3 / c).astype(np.int64)  # about 3 labels per image
    logits = rng.standard_normal((n, c)) + 2.0 * target_np - 2.0
    probs_np = (1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    probs, target = torch.from_numpy(probs_np).cuda(), torch.from_numpy(target_np).cuda()
    mc = mt.MetricCollection(
        {
            "map": mt.BinnedAveragePrecision(num_classes=c, thresholds=THRESHOLDS),
            "r_at_p90": mt.BinnedRecallAtFixedPrecision(num_classes=c, min_precision=MIN_PRECISION, thresholds=THRESHOLDS),
        }
    )
    batches = _batches(n)
    t0 = _reset_stats(torch, mt)
    for s, e in batches:
        mc(probs[s:e], target[s:e])
    result = mc.compute()
    seconds, stats = _read_stats(torch, mt, t0, {"binned_counts": len(mc) * len(batches)})  # one per member per batch
    (tp, fp, fn), ap, r_at_p, th_at_p = _coco_curve_oracle(probs_np, target_np, mc["map"].thresholds.cpu().numpy())
    for member in mc.values():
        for name, want in zip(("TPs", "FPs", "FNs"), (tp, fp, fn)):
            if not np.array_equal(getattr(member, name).cpu().numpy(), want):
                raise AssertionError(f"coco curves {name}: counts differ from the numpy oracle")
    _close("coco per-label AP", torch.stack(result["map"]), ap, atol=1e-6)
    _close("coco recall at precision 0.9", result["r_at_p90"][0], r_at_p, atol=1e-6)
    _close("coco threshold at precision 0.9", result["r_at_p90"][1], th_at_p, atol=1e-6)
    _log(
        f"coco curves: MS-COCO 2014 val, {n} samples x {c} labels, T={THRESHOLDS}, in {len(batches)} batches:"
        f" counts match the numpy oracle exactly, per-label AP and recall at precision {MIN_PRECISION} within 1e-6"
        f" (mAP={ap.mean():.6f}, mean R@P90={r_at_p.mean():.6f}); {n / seconds:.0f} samples/s"
        f" ({seconds * 1e3 / len(batches):.2f} ms/batch, first batch included); kernel_stats {stats}"
    )
    return stats, (mc, probs, target)


def _ece_oracle(conf: np.ndarray, acc: np.ndarray, bounds: np.ndarray):
    """l1 calibration error over ``(b[i], b[i+1]]`` bins, in float64, and the bin counts."""
    bins = len(bounds) - 1
    idx = np.minimum(np.searchsorted(bounds, conf, side="left") - 1, bins - 1)
    keep = idx >= 0
    count = np.bincount(idx[keep], minlength=bins).astype(np.float64)
    conf_sum = np.bincount(idx[keep], weights=conf[keep].astype(np.float64), minlength=bins)
    acc_sum = np.bincount(idx[keep], weights=acc[keep].astype(np.float64), minlength=bins)
    filled = count > 0
    gap = np.abs(acc_sum[filled] / count[filled] - conf_sum[filled] / count[filled])
    return float(np.sum(gap * count[filled] / len(conf))), count


def run_imagenet_calibration(torch, mt, logits, target):
    """ImageNet-1k val calibration: streaming and buffered CalibrationError over phase 3's softmax."""
    probs, conf, acc = _top1_calibration(torch, logits, target)
    conf_np, acc_np = conf.cpu().numpy(), acc.cpu().numpy() == 1
    batches = _batches(len(target))
    out = {}
    for name, metric, expect in (
        ("streaming", mt.CalibrationError(n_bins=CAL_BINS, streaming_bins=True), len(batches)),
        ("buffered", mt.CalibrationError(n_bins=CAL_BINS), len(batches) + 1),  # a batch value per forward, then the epoch
    ):
        t0 = _reset_stats(torch, mt)
        for s, e in batches:
            metric(probs[s:e], target[s:e])
        value = metric.compute()
        seconds, stats = _read_stats(torch, mt, t0, {"binned_calibration": expect})
        ece, count = _ece_oracle(conf_np, acc_np, metric.bin_boundaries.cpu().numpy())
        _close(f"imagenet ECE ({name})", value, ece, rtol=1e-5)
        if name == "streaming" and not np.array_equal(metric.bin_count.cpu().numpy(), count):
            raise AssertionError("imagenet calibration: bin counts differ from the numpy oracle")
        out[name] = (metric, stats)
        _log(
            f"imagenet calibration ({name}): {len(target)} samples, {CAL_BINS} bins, in {len(batches)} batches:"
            f" ECE={float(value):.6f} matches the numpy oracle within 1e-5 relative; {len(target) / seconds:.0f} samples/s"
            f" ({seconds * 1e3 / len(batches):.2f} ms/batch); kernel_stats {stats}"
        )
    return out, probs


def _rank_auroc(scores: np.ndarray, positive: np.ndarray) -> float:
    """Exact AUROC as the Mann-Whitney statistic, ties counted half."""
    _, inverse, counts = np.unique(scores, return_inverse=True, return_counts=True)
    ends = np.cumsum(counts)
    mid_rank = ends - (counts - 1) / 2.0  # 1-based mean rank of each distinct score
    n_pos = positive.sum()
    n_neg = len(scores) - n_pos
    return float((mid_rank[inverse][positive].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def _binned_auroc(scores: np.ndarray, positive: np.ndarray, ths: np.ndarray) -> float:
    tp, fp, fn = _threshold_counts(scores, positive, ths)
    tn = (~positive).sum() - fp
    tpr = np.concatenate([[0.0], (tp / (tp + fn))[::-1], [1.0]])
    fpr = np.concatenate([[0.0], (fp / (fp + tn))[::-1], [1.0]])
    return float(np.sum((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2.0))


def run_ctr_auroc(torch, mt, rng):
    """Binary AUROC over a CTR model's eval pass, binned beside exact."""
    n, batch = CTR_EVAL
    clicked = rng.random(n) < 0.034  # about Criteo's click rate
    scores_np = (1.0 / (1.0 + np.exp(-(rng.standard_normal(n) + 1.2 * clicked - 3.0)))).astype(np.float32)
    scores, labels = torch.from_numpy(scores_np).cuda(), torch.from_numpy(clicked.astype(np.int64)).cuda()
    mc = mt.MetricCollection({"auroc_binned": mt.AUROC(thresholds=THRESHOLDS), "auroc_exact": mt.AUROC()})
    batches = [(s, s + batch) for s in range(0, n, batch)]
    t0 = _reset_stats(torch, mt)
    for s, e in batches:
        mc(scores[s:e], labels[s:e])
    result = mc.compute()
    seconds, stats = _read_stats(torch, mt, t0, {"binned_counts": len(batches)})
    ths = mc["auroc_binned"].thresholds.cpu().numpy()
    tp, fp, fn = _threshold_counts(scores_np, clicked, ths)
    for name, want in zip(("bTPs", "bFPs", "bFNs", "bTNs"), (tp, fp, fn, (~clicked).sum() - fp)):
        if not np.array_equal(getattr(mc["auroc_binned"], name).cpu().numpy(), want):
            raise AssertionError(f"ctr binned AUROC {name}: counts differ from the numpy oracle")
    binned = _binned_auroc(scores_np, clicked, ths)
    exact = _rank_auroc(scores_np, clicked)
    _close("ctr binned AUROC", result["auroc_binned"], binned, atol=1e-6)
    _close("ctr exact AUROC", result["auroc_exact"], exact, atol=1e-6)
    _log(
        f"ctr auroc: {n} binary samples in {len(batches)} batches of {batch}: binned counts match the numpy oracle exactly;"
        f" binned (T={THRESHOLDS}) {float(result['auroc_binned']):.6f} and exact {float(result['auroc_exact']):.6f} match theirs within 1e-6; {n / seconds:.0f} samples/s"
        f" ({seconds * 1e3 / len(batches):.2f} ms/batch, both members, first batch and the exact sort of all samples included); kernel_stats {stats}"
    )
    return stats, (mc, scores, labels)


# kernel wrappers' device-side names, as the profiler reports them
KERNEL_SYMBOLS = {
    "confusion_counts": "confusion_counts_kernel",
    "multilabel_counts": "multilabel_counts_kernel",
    "select_topk": "topk_mask_kernel",
    "binned_counts": "binned_counts_kernel",
    "binned_calibration": "binned_calibration_kernel",
}
PROFILE_BATCHES = 3


def _device_rows(prof):
    """Device-side events (kernels, memcpy, memset) by name; the CPU ops that
    launched them are left out, since they carry the same time again."""
    rows = []
    for evt in prof.key_averages():
        if "CUDA" not in str(getattr(evt, "device_type", "")):
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us:
            rows.append({"name": evt.key, "calls": evt.count, "device_us": dev_us})
    return sorted(rows, key=lambda r: -r["device_us"])


def _profile_path(torch, label: str, steps, top: int) -> None:
    """Wall and device time, busy share, events and host syncs per batch of one path."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for step in steps:
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / len(steps)
    rows = _device_rows(prof)
    # one stream: device events do not overlap, so their sum is the busy time
    device_ms = sum(r["device_us"] for r in rows) / 1e3 / len(steps)
    events = sum(r["calls"] for r in rows)

    # host syncs per batch (the value checks' .item() calls, among others)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            steps[0]()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    if not rows:
        _log(f"profile {label}: batch {wall_ms:.2f} ms on the host clock; device time not measured (no device events)")
        return
    _log(
        f"profile {label}: batch (mean of {len(steps)}) {wall_ms:.2f} ms wall, {device_ms:.3f} ms device,"
        f" busy share {device_ms / wall_ms:.3f}, {events / len(steps):.0f} device events, {syncs} host syncs;"
        f" top device ops over the {len(steps)} batches:"
    )
    for r in rows[:top]:
        _log(f"  {r['device_us']:10.1f} us  x{r['calls']:<4d} {r['name'][:100]}")


def profile_device_time(torch, kernel_calls, paths):
    """Each kernel's device time per launch; then, for each path, the device
    busy share, host syncs and top device ops of a few of its batches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for call in kernel_calls.values():
            for _ in range(10):
                call()
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    kernel_us = {}
    for name, symbol in KERNEL_SYMBOLS.items():
        hits = [r for r in rows if symbol in r["name"]]
        kernel_us[name] = sum(r["device_us"] for r in hits) / sum(r["calls"] for r in hits) if hits else None
    shown = {k: ("not measured" if v is None else f"{v:.2f} us") for k, v in kernel_us.items()}
    _log(f"profile: device time per launch {shown}")
    for i, (label, steps) in enumerate(paths.items()):
        _profile_path(torch, label, steps, top=15 if i == 0 else 8)
    return kernel_us


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU.", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import metrics_tpu_torch as mt
    from metrics_tpu_torch.ops import _build

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    _log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    _log(smi)

    _build.library()
    _log(f"build: {_build.last_build_seconds:.1f} s (0.0 = reused) -> {_build._library_path().name}")
    for line in _build.last_build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            _log(f"  ptxas: {line.strip()}")

    rng = np.random.default_rng(SEED)
    records, calls = check_and_time_kernels(torch, rng)
    binned_records, binned_calls = check_and_time_binned(torch, rng)
    records.update(binned_records)
    calls.update(binned_calls)
    main_stats, mc, logits, target = run_main_path(torch, mt, rng)
    ml_stats = run_multilabel(torch, mt, rng)
    coco_stats, (curves, coco_probs, coco_target) = run_coco_curves(torch, mt, rng)
    calibration, probs = run_imagenet_calibration(torch, mt, logits, target)
    ctr_stats, (aurocs, ctr_scores, ctr_labels) = run_ctr_auroc(torch, mt, rng)

    def steps(metric, preds, labels, bounds):
        return [lambda s=s, e=e: metric(preds[s:e], labels[s:e]) for s, e in bounds[:PROFILE_BATCHES]]

    kernel_us = profile_device_time(
        torch,
        calls,
        {
            "imagenet main path": steps(mc, logits, target, _batches(IMAGENET_VAL[0])),
            "coco curves": steps(curves, coco_probs, coco_target, _batches(COCO_VAL[0])),
            "imagenet calibration (streaming)": steps(calibration["streaming"][0], probs, target, _batches(IMAGENET_VAL[0])),
            "ctr auroc (binned + exact)": steps(aurocs, ctr_scores, ctr_labels, [(s, s + CTR_EVAL[1]) for s in range(0, CTR_EVAL[0], CTR_EVAL[1])]),
        },
    )

    # each kernel's launches on the paths that run it, each counted from 0 just before its run
    launches = {
        **{k: v["launches"] for k, v in main_stats.items()},
        "multilabel_counts": ml_stats["multilabel_counts"]["launches"],
        "binned_counts": coco_stats["binned_counts"]["launches"] + ctr_stats["binned_counts"]["launches"],
        "binned_calibration": sum(stats["binned_calibration"]["launches"] for _, stats in calibration.values()),
    }
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": rec["source"],
            "replaces": rec["replaces"],
            "launches": launches[name],
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            "device_us": kernel_us[name],
        }
        for name, rec in records.items()
    ]
    _log(smi)
    _log(json.dumps({"kernels": kernels}))
    _log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

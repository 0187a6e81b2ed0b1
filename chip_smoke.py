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
5. A profile: each kernel's device time per launch, and the device busy
   share, host syncs and top device ops of main-path batches.

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

# NVIDIA H100 SXM data sheet: HBM rate and the CUDA-core float32 rate (no
# tensor-core type applies to these integer and compare workloads)
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12


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
    cases = {"main": (x, TOP_K), "ragged": (x[:RAGGED], TOP_K), "bf16": (x.bfloat16(), TOP_K), "f16": (x.half(), 3)}
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


def _imagenet_stream(rng):
    """Seeded ImageNet-1k-val-size logits with a signal on the target class."""
    n, c = IMAGENET_VAL
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


# kernel wrappers' device-side names, as the profiler reports them
KERNEL_SYMBOLS = {
    "confusion_counts": "confusion_counts_kernel",
    "multilabel_counts": "multilabel_counts_kernel",
    "select_topk": "topk_mask_kernel",
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


def profile_device_time(torch, kernel_calls, mc, logits, target):
    """Each kernel's device time per launch, and the device busy share, host
    syncs and top device ops over main-path batches."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        for call in kernel_calls.values():
            for _ in range(10):
                call()
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    kernel_us = {}
    for name, symbol in KERNEL_SYMBOLS.items():
        hits = [r for r in rows if symbol in r["name"]]
        kernel_us[name] = sum(r["device_us"] for r in hits) / sum(r["calls"] for r in hits) if hits else None

    batches = [(logits[s:e], target[s:e]) for s, e in _batches(IMAGENET_VAL[0])[:PROFILE_BATCHES]]
    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in batches:
            mc(*batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    rows = _device_rows(prof)
    # one stream: device events do not overlap, so their sum is the busy time
    device_ms = sum(r["device_us"] for r in rows) / 1e3 / len(batches)
    events = sum(r["calls"] for r in rows)

    # host syncs per batch (the value checks' .item() calls, among others)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            mc(*batches[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    shown = {k: ("not measured" if v is None else f"{v:.2f} us") for k, v in kernel_us.items()}
    _log(f"profile: device time per launch {shown}")
    if not rows:
        _log(f"profile: main-path batch {wall_ms:.2f} ms on the host clock; device time not measured (no device events)")
        return kernel_us
    _log(
        f"profile: main-path batch (mean of {len(batches)}) {wall_ms:.2f} ms wall, {device_ms:.3f} ms device,"
        f" busy share {device_ms / wall_ms:.3f}, {events / len(batches):.0f} device events, {syncs} host syncs;"
        f" top device ops over the {len(batches)} batches:"
    )
    for r in rows[:15]:
        _log(f"  {r['device_us']:10.1f} us  x{r['calls']:<4d} {r['name'][:100]}")
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
    main_stats, mc, logits, target = run_main_path(torch, mt, rng)
    ml_stats = run_multilabel(torch, mt, rng)
    kernel_us = profile_device_time(torch, calls, mc, logits, target)

    launches = {**{k: v["launches"] for k, v in main_stats.items()}, "multilabel_counts": ml_stats["multilabel_counts"]["launches"]}
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

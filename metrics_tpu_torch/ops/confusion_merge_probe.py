"""Times the ``confusion_counts`` shared route with and without warp-aggregated
increments, on one NVIDIA GPU.

    python3 -m metrics_tpu_torch.ops.confusion_merge_probe

Builds the kernel library twice from ``csrc/``: as shipped, and with
``-DMT_CC_MERGE=1`` (lanes of one cell found with ``__match_any_sync``, the
lowest adding the group's size once). Both are held against the plain
version bit for bit, then timed with CUDA events in the order shipped,
merge, merge, shipped on N = 16,777,216 samples at C = 20:

* ``runs``: segmentation labels, one class per run of 32 samples, class 0 on
  a third of the runs, 8% of the predictions wrong (``chip_smoke.py``'s 9c
  shape);
* ``uniform``: both indices uniform over the 20 classes (nothing merges);
* ``hot70``: 70% of the samples on one cell, the rest uniform;
* ``one_cell``: every sample on one cell;

each in int64 and int32, beside ``torch.bincount(target * C + preds)`` and
the byte bound (both vectors read once at 3.35 TB/s). Prints the card's
name and power limit, then one JSON line of ms per call.
"""
import json
import subprocess
import sys

import torch

from metrics_tpu_torch.ops import _build
from metrics_tpu_torch.ops import confusion_counts as cc

N = 16_777_216
C = 20
RUN = 32
ERROR = 0.08
HBM_BYTES_PER_S = 3.35e12


def _inputs(gen: torch.Generator, dev: torch.device) -> dict:
    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=dev)

    def uniform(n):
        return torch.randint(0, C, (n,), generator=gen, device=dev)

    runs = N // RUN
    cls = torch.where(rand(runs) < 1 / 3, 0, uniform(runs)).repeat_interleave(RUN)
    hot = rand(N) < 0.7
    return {
        "runs": (torch.where(rand(N) < ERROR, uniform(N), cls), cls),
        "uniform": (uniform(N), uniform(N)),
        "hot70": (torch.where(hot, 3, uniform(N)), torch.where(hot, 3, uniform(N))),
        "one_cell": (torch.full((N,), 3, device=dev), torch.full((N,), 3, device=dev)),
    }


def _ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _library(extra_flags):
    """The kernel library built with ``extra_flags`` added to the nvcc flags."""
    flags = _build.NVCC_FLAGS
    _build.NVCC_FLAGS, _build._LIB = flags + extra_flags, None
    try:
        return _build.library()
    finally:
        _build.NVCC_FLAGS, _build._LIB = flags, None


def main() -> int:
    if not torch.cuda.is_available():
        print("confusion_merge_probe: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    libs = {"shipped": _library([]), "merge": _library(["-DMT_CC_MERGE=1"])}
    data = {}
    for name, (p, t) in _inputs(torch.Generator(device=dev).manual_seed(0), dev).items():
        for dtype in (torch.int64, torch.int32):
            data[f"{name}/{str(dtype).removeprefix('torch.')}"] = (p.to(dtype), t.to(dtype))

    def run(variant, p, t):
        _build._LIB = libs[variant]
        return cc._confusion_counts_cuda(p, t, C)

    for key, (p, t) in data.items():
        want = cc._confusion_counts_plain(p, t, C)
        for variant in libs:
            if not torch.equal(run(variant, p, t), want):
                raise AssertionError(f"{variant} differs from the plain version on {key}")
    times = {key: {} for key in data}
    for variant in ("shipped", "merge", "merge", "shipped"):
        for key, (p, t) in data.items():
            times[key].setdefault(variant, []).append(round(_ms(lambda: run(variant, p, t)), 4))
    _build._LIB = None
    for key, (p, t) in data.items():
        times[key]["bincount"] = round(_ms(lambda: torch.bincount(t.long() * C + p.long(), minlength=C * C)), 4)
        times[key]["bound"] = round(2 * N * p.element_size() / HBM_BYTES_PER_S * 1e3, 4)
    print(json.dumps({"n": N, "c": C, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

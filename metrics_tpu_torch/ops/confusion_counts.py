"""Confusion counts behind ``ConfusionMatrix`` (counterpart of
``metrics_tpu/ops/confusion_counts.py``).

* ``confusion_counts``: ``[C, C]`` multiclass counts, rows = target,
  cols = preds. Indices outside ``[0, C)`` are dropped, as the Pallas kernel
  drops them (its XLA composition would clip negatives into bin 0;
  validated input never holds either).
* ``multilabel_counts``: ``[C, 2, 2]`` per-class ``[[tn, fp], [fn, tp]]``
  from 0/1 ``[N, C]`` inputs.

Both take a class window for the sharded state plane, where a process
keeps only its rows of a class-split ``ConfusionMatrix``:
``confusion_counts(..., rows=(r0, R))`` gives the ``[R, C]`` counts of the
pairs with ``r0 <= target < r0 + R`` (others dropped, as out-of-range
indices are), never building ``[C, C]``; ``multilabel_counts(...,
cols=(c0, W))`` the ``[W, 2, 2]`` counts of columns ``[c0, c0 + W)``, read
in place. Without a window each is the whole matrix, bit for bit as before.

Both return int64. The CUDA kernels are in ``csrc/confusion_counts.cu``;
each has its plain PyTorch version here, which the CPU path runs and the
kernel is held against bit for bit. The multiclass kernel reads int32 and
int64 indices as given and counts in shared memory up to C = 241, in 64-bit
global atomics past it; :func:`_confusion_route` picks the route. The
multilabel kernel writes the ``[C, 2, 2]`` counts itself in one launch (a
cluster per tile of up to 16 columns); :func:`_multilabel_route` picks its
lanes per row and load width.
"""
from typing import Optional, Tuple

import torch

from metrics_tpu_torch.ops import _build
from metrics_tpu_torch.ops import registry as _registry


def _is_int(x: torch.Tensor) -> bool:
    return not x.is_floating_point() and not x.is_complex() and x.dtype != torch.bool


def _window(window: Optional[Tuple[int, int]], n: int) -> Tuple[int, int]:
    return (0, n) if window is None else (int(window[0]), int(window[1]))


def _window_ok(window: Optional[Tuple[int, int]], n: int, what: str) -> Tuple[bool, str]:
    start, length = _window(window, n)
    if start < 0 or length < 0 or start + length > n:
        return False, f"the {what} window {window} does not lie in [0, {n})"
    return True, "ok"


def _confusion_eligible(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, rows: Optional[Tuple[int, int]] = None
) -> Tuple[bool, str]:
    if num_classes < 1:
        return False, f"num_classes must be >= 1, got {num_classes}"
    ok, why = _window_ok(rows, num_classes, "row")
    if not ok:
        return ok, why
    if preds.ndim != 1 or preds.shape != target.shape:
        return False, f"preds and target must be 1-D of one length, got {tuple(preds.shape)} and {tuple(target.shape)}"
    if not (_is_int(preds) and _is_int(target)):
        return False, f"preds and target must be integer class indices, got {preds.dtype} and {target.dtype}"
    if preds.device != target.device:
        return False, f"preds on {preds.device} and target on {target.device}"
    return True, "ok"


def _confusion_counts_plain(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, rows: Optional[Tuple[int, int]] = None
) -> torch.Tensor:
    """Index-add over the fused index ``(target - r0)*C + preds``; pairs out
    of range or out of the row window go to one spare bin that is cut off."""
    c = num_classes
    r0, nr = _window(rows, c)
    p, t = preds.long(), target.long()
    valid = (p >= 0) & (p < c) & (t >= r0) & (t < r0 + nr)
    idx = torch.where(valid, (t - r0) * c + p, torch.full_like(t, nr * c))
    bins = torch.zeros(nr * c + 1, dtype=torch.int64, device=preds.device)
    bins.index_add_(0, idx, torch.ones_like(idx))
    return bins[: nr * c].reshape(nr, c)


#: Dynamic shared memory an H100 block may opt into (227 KB), and the warps
#: of a block of the shared-route kernel (``kSmWarps`` in the source). The
#: route is chosen here alone: the kernel takes the copies it is given, and a
#: request past the device's opt-in limit fails at the launch, so both
#: numbers must match the card and the source.
_SMEM_BYTES = 232_448
_SM_WARPS = 16


def _confusion_route(c: int, rows: Optional[int] = None) -> Tuple[str, int]:
    """``(route, histograms per block)`` of the multiclass kernel for ``c``
    classes and a window of ``rows`` target rows (all ``c`` by default):
    ``("shared", copies)`` while one ``[rows, c]`` histogram of 4-byte
    counters fits a block's shared memory (c <= 241 for the whole matrix),
    with one copy per warp halved until the copies fit half an SM's (two
    blocks resident), and at least one; else ``("global", 0)``."""
    per_copy = 4 * (c if rows is None else rows) * c
    if per_copy > _SMEM_BYTES:
        return "global", 0
    copies = _SM_WARPS
    while copies > 1 and copies * per_copy > _SMEM_BYTES // 2:
        copies //= 2
    return "shared", copies


def _index_dtype(preds: torch.Tensor, target: torch.Tensor) -> torch.dtype:
    """The dtype the kernel reads: int32 or int64 indices as given, anything
    else (a mix, a narrower or unsigned type) cast to int64."""
    if preds.dtype == target.dtype and preds.dtype in (torch.int32, torch.int64):
        return preds.dtype
    return torch.int64


def _confusion_counts_cuda(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, rows: Optional[Tuple[int, int]] = None
) -> torch.Tensor:
    lib = _build.library()
    dtype = _index_dtype(preds, target)
    p = preds.to(dtype).contiguous()
    t = target.to(dtype).contiguous()
    r0, nr = _window(rows, num_classes)
    _, copies = _confusion_route(num_classes, nr)
    out = torch.zeros((nr, num_classes), dtype=torch.int64, device=p.device)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    err = lib.mt_confusion_counts(
        p.device.index, t.data_ptr(), p.data_ptr(), p.numel(), num_classes, r0, nr, p.element_size(), copies,
        out.data_ptr(), stream,
    )
    _build.check(lib, err, "confusion_counts kernel")
    _registry.count_launch("confusion_counts")
    return out


def _multilabel_eligible(
    preds: torch.Tensor, target: torch.Tensor, cols: Optional[Tuple[int, int]] = None
) -> Tuple[bool, str]:
    if preds.ndim != 2 or preds.shape != target.shape:
        return False, f"preds and target must be 2-D of one shape, got {tuple(preds.shape)} and {tuple(target.shape)}"
    ok, why = _window_ok(cols, int(preds.shape[1]), "column")
    if not ok:
        return ok, why
    if not (_is_int(preds) and _is_int(target)):
        return False, f"preds and target must be 0/1 integers, got {preds.dtype} and {target.dtype}"
    if preds.device != target.device:
        return False, f"preds on {preds.device} and target on {target.device}"
    return True, "ok"


def _multilabel_counts_plain(
    preds: torch.Tensor, target: torch.Tensor, cols: Optional[Tuple[int, int]] = None
) -> torch.Tensor:
    if cols is not None:
        c0, w = _window(cols, int(preds.shape[1]))
        preds, target = preds[:, c0:c0 + w], target[:, c0:c0 + w]
    p = preds.to(torch.int64)
    t = target.to(torch.int64)
    n = p.shape[0]
    tp, sum_p, sum_t = (p * t).sum(0), p.sum(0), t.sum(0)
    tn = n - sum_p - sum_t + tp
    return torch.stack([tn, sum_p - tp, sum_t - tp, tp], dim=-1).reshape(-1, 2, 2)


#: Columns a block of the multilabel kernel covers (``kMlTile`` in the source).
_ML_TILE = 16


def _multilabel_route(c: int, preds_ptr: int, target_ptr: int, ld: Optional[int] = None) -> Tuple[int, bool]:
    """``(lanes per row, 16-byte loads)`` of the multilabel kernel for ``c``
    int32 columns at these addresses, rows ``ld`` columns apart (``c`` by
    default): a lane loads 4 columns at once where ``c`` and ``ld`` are
    multiples of 4 and both inputs are 16-byte aligned, else 1; a block's
    tile is at most 16 columns, in a power of 2 of lanes."""
    ld = c if ld is None else ld
    vec = c % 4 == 0 and ld % 4 == 0 and preds_ptr % 16 == 0 and target_ptr % 16 == 0
    per_lane = 4 if vec else 1
    lanes = 1
    while lanes * per_lane < min(c, _ML_TILE):
        lanes *= 2
    return lanes, vec


def _multilabel_counts_cuda(
    preds: torch.Tensor, target: torch.Tensor, cols: Optional[Tuple[int, int]] = None
) -> torch.Tensor:
    lib = _build.library()
    p = preds.to(torch.int32).contiguous()
    t = target.to(torch.int32).contiguous()
    n, ld = p.shape
    c0, c = _window(cols, ld)
    # the window's first column, read in place at the rows' stride
    p_ptr, t_ptr = p.data_ptr() + 4 * c0, t.data_ptr() + 4 * c0
    lanes, vec = _multilabel_route(c, p_ptr, t_ptr, ld)
    out = torch.empty((c, 2, 2), dtype=torch.int64, device=p.device)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    err = lib.mt_multilabel_counts(p.device.index, p_ptr, t_ptr, n, c, ld, lanes, int(vec), out.data_ptr(), stream)
    _build.check(lib, err, "multilabel_counts kernel")
    _registry.count_launch("multilabel_counts")
    return out


def confusion_counts(
    preds: torch.Tensor, target: torch.Tensor, num_classes: int, rows: Optional[Tuple[int, int]] = None
) -> torch.Tensor:
    """``[C, C]`` int64 confusion counts of flattened index tensors; with
    ``rows=(r0, R)`` the ``[R, C]`` rows ``r0 .. r0 + R - 1`` alone."""
    if rows is None:
        return _registry.dispatch("confusion_counts", preds.reshape(-1), target.reshape(-1), num_classes=num_classes)
    return _registry.dispatch(
        "confusion_counts", preds.reshape(-1), target.reshape(-1), num_classes=num_classes, rows=tuple(rows)
    )


def multilabel_counts(
    preds: torch.Tensor, target: torch.Tensor, cols: Optional[Tuple[int, int]] = None
) -> torch.Tensor:
    """``[C, 2, 2]`` int64 per-class ``[[tn, fp], [fn, tp]]`` of 0/1 ``[N, C]``
    inputs; with ``cols=(c0, W)`` the ``[W, 2, 2]`` of columns ``c0 .. c0 + W - 1``."""
    if cols is None:
        return _registry.dispatch("multilabel_counts", preds, target)
    return _registry.dispatch("multilabel_counts", preds, target, cols=tuple(cols))


_registry.register(
    _registry.KernelOp(
        name="confusion_counts",
        kernel=_confusion_counts_cuda,
        plain=_confusion_counts_plain,
        eligible=_confusion_eligible,
    )
)
_registry.register(
    _registry.KernelOp(
        name="multilabel_counts",
        kernel=_multilabel_counts_cuda,
        plain=_multilabel_counts_plain,
        eligible=_multilabel_eligible,
    )
)

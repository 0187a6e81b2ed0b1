"""Top-k mask behind every ``top_k > 1`` classification metric (counterpart
of ``metrics_tpu/ops/select_topk.py``).

``select_topk_mask(x, k)`` is the 0/1 int32 mask of each row's k largest
entries of a float ``[N, C]`` matrix, with the Pallas kernel's semantics:
NaN ranks greatest, ``-0.0`` and ``0.0`` tie, ties go to the lowest column,
and ``-inf`` entries can be picked. (``lax.top_k``, the JAX package's XLA
composition, orders ``0.0`` above ``-0.0``; the port follows the kernel.)
bfloat16 and float16 inputs are widened to float32 first, which is exact;
float64 inputs are ranked as float64, never narrowed (a cast could merge
distinct scores into ties and change the mask).

The CUDA kernels are in ``csrc/select_topk.cu`` (they replace
``_topk_mask_kernel``, ``metrics_tpu/ops/select_topk.py:38``). The function
is bound by bytes: the row read once and the mask written once, 19.6 us at
[8192, 1000] on an H100 at 3.35 TB/s. :func:`_topk_route` picks one:

* float32 (bfloat16 and float16 widened) rows of at most 1024 columns: the
  register kernel, one warp per row holding it as order keys in registers
  (4, 8, 16 or 32 per lane), two warp reductions per round (the largest
  key, then its lowest column), no shared memory, the next row's loads in
  flight during the current row's rounds; 16-byte loads and stores when the width is a multiple of 4 and the
  rows are 16-byte aligned, 4-byte ones otherwise;
* wider float32 rows (up to 46,489 columns): the shared-memory kernel of the
  first design, which rescans the row in shared memory each round;
* float64 rows: a shared-memory kernel with 64-bit keys.

The plain version here is a stable descending sort and a scatter.
``torch.topk`` is not used: it does not promise that ties go to the lowest
index.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.ops import _build
from metrics_tpu_torch.ops import registry as _registry

_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64)
#: One warp holds a row in shared memory (a 4-byte key, 8-byte for float64,
#: and a 1-byte flag per column) within the 227 KB a block can have on Hopper.
_SMEM_BYTES = 227 * 1024


def _max_columns(dtype: torch.dtype) -> int:
    return _SMEM_BYTES // (9 if dtype == torch.float64 else 5)


#: Widest float32 row the register kernel holds: 32 keys per lane.
_REGISTER_COLUMNS = 1024


def _topk_route(dtype: torch.dtype, c: int, data_ptr: int) -> Tuple[str, int, bool]:
    """``(kernel, keys per lane, 16-byte loads)`` for rows of ``c`` columns of
    ``dtype`` (after the wrapper's widening) starting at ``data_ptr``:
    ``"registers"``, ``"shared"`` or ``"shared_f64"``."""
    if dtype == torch.float64:
        return "shared_f64", 0, False
    if c > _REGISTER_COLUMNS:
        return "shared", 0, False
    keys = 4
    while 32 * keys < c:
        keys *= 2
    return "registers", keys, c % 4 == 0 and data_ptr % 16 == 0


def _topk_eligible(x: torch.Tensor, k: int) -> Tuple[bool, str]:
    if x.ndim != 2:
        return False, f"x must be 2-D, got shape {tuple(x.shape)}"
    if x.dtype not in _DTYPES:
        return False, f"x must be float32, float64, bfloat16 or float16, got {x.dtype}"
    if not 2 <= k <= x.shape[1]:
        return False, f"k must be in [2, {x.shape[1]}] (k = 1 is the argmax path), got {k}"
    if x.shape[1] > _max_columns(x.dtype):
        return False, f"rows of {x.shape[1]} columns exceed the {_max_columns(x.dtype)} a warp can hold in shared memory"
    return True, "ok"


def _topk_mask_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    v = x if x.dtype == torch.float64 else x.float()
    nan = torch.isnan(v)
    # NaN sorts as +inf here and is moved ahead of +inf by the second sort;
    # -0.0 is folded onto 0.0 so the two tie
    v = torch.where(nan, torch.full_like(v, float("inf")), torch.where(v == 0, torch.zeros_like(v), v))
    order = torch.sort(v, dim=1, descending=True, stable=True).indices
    order = order.gather(1, torch.sort(nan.gather(1, order).to(torch.uint8), dim=1, descending=True, stable=True).indices)
    return torch.zeros(v.shape, dtype=torch.int32, device=v.device).scatter_(1, order[:, :k], 1)


def _topk_mask_cuda(x: torch.Tensor, k: int) -> torch.Tensor:
    lib = _build.library()
    v = x.contiguous() if x.dtype == torch.float64 else x.to(torch.float32).contiguous()
    n, c = v.shape
    out = torch.empty((n, c), dtype=torch.int32, device=v.device)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    route, keys, vec = _topk_route(v.dtype, c, v.data_ptr())
    if route == "registers":
        err = lib.mt_topk_mask_regs(v.device.index, v.data_ptr(), n, c, k, keys, int(vec), out.data_ptr(), stream)
    else:
        entry = lib.mt_topk_mask_f64 if route == "shared_f64" else lib.mt_topk_mask
        err = entry(v.device.index, v.data_ptr(), n, c, k, out.data_ptr(), stream)
    _build.check(lib, err, "select_topk kernel")
    _registry.count_launch("select_topk")
    return out


def select_topk_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """0/1 int32 mask of each row's k largest entries (``2 <= k <= C``)."""
    return _registry.dispatch("select_topk", x, k)


_registry.register(
    _registry.KernelOp(
        name="select_topk",
        kernel=_topk_mask_cuda,
        plain=_topk_mask_plain,
        eligible=_topk_eligible,
    )
)

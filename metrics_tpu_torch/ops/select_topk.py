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

The CUDA kernel is in ``csrc/select_topk.cu``; the plain version here is a
stable descending sort and a scatter. ``torch.topk`` is not used: it does
not promise that ties go to the lowest index.
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
    wide = x.dtype == torch.float64
    v = x.contiguous() if wide else x.to(torch.float32).contiguous()
    n, c = v.shape
    out = torch.empty((n, c), dtype=torch.int32, device=v.device)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    entry = lib.mt_topk_mask_f64 if wide else lib.mt_topk_mask
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

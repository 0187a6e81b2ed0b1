"""Row sums of a pairwise distance or similarity matrix that is never built
(counterpart of ``metrics_tpu/ops/pairwise_reduce.py``).

``pairwise_reduce(x, y, op, zero_diagonal)`` gives, for each row i of
``x [N, d]``, the sum over the rows j of ``y [M, d]`` of

* ``op="euclidean"``: ``sqrt(max(||x_i||² + ||y_j||² − 2·x_i·y_j, 0))``;
* ``op="cosine"``: ``x_i·y_j`` (the caller passes normalized rows);

leaving out the cells ``i == j``, ``i < min(N, M)``, when ``zero_diagonal``.
The clamp keeps NaN, so a NaN in a row spoils its sum as it does in the JAX
package's composition.

The numbers follow the JAX package's XLA composition, which is what its
users run (its Pallas kernel, registered off by default there, multiplies
in bfloat16): the sums come back in float32, or float64 when an input is
float64; bfloat16 and float16 inputs are widened to float32.
:func:`pairwise_reduce_rows`, which the pairwise functionals call, divides
by M for ``"mean"`` and returns the inputs' dtype, as the composition does.

The CUDA kernel is in ``csrc/pairwise_reduce.cu`` and has no cap on ``d``.
The plain version here forms the matrix in row chunks of about 1 GB with
``torch.matmul``; it is the CPU path and the reference on the card.
"""
from typing import Tuple

import torch

from metrics_tpu_torch.ops import _build
from metrics_tpu_torch.ops import registry as _registry

OPS = ("euclidean", "cosine")
#: C-side dtype codes of ``mt_pairwise_reduce``.
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2, torch.float16: 3}
#: Elements of the ``[rows, M]`` block the plain version holds at once (1 GB of float32).
_PLAIN_BLOCK_ELEMENTS = 1 << 28


def _sum_dtype(x: torch.Tensor, y: torch.Tensor) -> torch.dtype:
    return torch.float64 if torch.float64 in (x.dtype, y.dtype) else torch.float32


def _pairwise_eligible(x: torch.Tensor, y: torch.Tensor, op: str = "euclidean", zero_diagonal: bool = False) -> Tuple[bool, str]:
    if x.ndim != 2 or y.ndim != 2:
        return False, f"x and y must be 2-D, got shapes {tuple(x.shape)} and {tuple(y.shape)}"
    if x.shape[1] != y.shape[1]:
        return False, f"x and y must have the same width d, got {x.shape[1]} and {y.shape[1]}"
    if op not in OPS:
        return False, f"op must be one of {OPS}, got {op!r}"
    if x.dtype not in _DTYPE_CODES or y.dtype not in _DTYPE_CODES:
        return False, f"x and y must be float32, float64, bfloat16 or float16, got {x.dtype} and {y.dtype}"
    if x.device != y.device:
        return False, f"x on {x.device}, y on {y.device}"
    return True, "ok"


def _pairwise_plain(x: torch.Tensor, y: torch.Tensor, op: str = "euclidean", zero_diagonal: bool = False) -> torch.Tensor:
    dtype = _sum_dtype(x, y)
    x, y = x.to(dtype), y.to(dtype)
    n, m = x.shape[0], y.shape[0]
    out = torch.empty(n, dtype=dtype, device=x.device)
    y_norm = (y * y).sum(dim=1)[None, :] if op == "euclidean" else None
    step = max(1, (_PLAIN_BLOCK_ELEMENTS * 4 // dtype.itemsize) // max(m, 1))
    for s in range(0, n, step):
        e = min(s + step, n)
        vals = x[s:e] @ y.T
        if op == "euclidean":
            x_norm = (x[s:e] * x[s:e]).sum(dim=1, keepdim=True)
            vals = ((x_norm + y_norm) - 2 * vals).clamp(min=0).sqrt()
        if zero_diagonal and s < m:
            diag = torch.arange(s, min(e, m), device=x.device)
            vals[diag - s, diag] = 0
        out[s:e] = vals.sum(dim=1)
    return out


def _pairwise_cuda(x: torch.Tensor, y: torch.Tensor, op: str = "euclidean", zero_diagonal: bool = False) -> torch.Tensor:
    lib = _build.library()
    if x.dtype != y.dtype:
        x, y = x.to(_sum_dtype(x, y)), y.to(_sum_dtype(x, y))
    x, y = x.contiguous(), y.contiguous()
    (n, d), m = x.shape, y.shape[0]
    out = torch.empty(n, dtype=_sum_dtype(x, y), device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.mt_pairwise_reduce(
        x.device.index, _DTYPE_CODES[x.dtype], OPS.index(op), x.data_ptr(), y.data_ptr(), n, m, d,
        int(zero_diagonal), out.data_ptr(), stream,
    )
    _build.check(lib, err, "pairwise_reduce kernel")
    _registry.count_launch("pairwise_reduce")
    return out


def pairwise_reduce(x: torch.Tensor, y: torch.Tensor, op: str = "euclidean", zero_diagonal: bool = False) -> torch.Tensor:
    """Row sums ``[N]`` (float32, float64 for float64 inputs) of the
    ``op`` matrix of ``x [N, d]`` against ``y [M, d]``."""
    return _registry.dispatch("pairwise_reduce", x, y, op=op, zero_diagonal=zero_diagonal)


def pairwise_reduce_rows(
    x: torch.Tensor, y: torch.Tensor, op: str, reduction: str, zero_diagonal: bool
) -> torch.Tensor:
    """Row-reduced pairwise op without the ``[N, M]`` matrix, in the inputs'
    dtype: ``reduction`` ``"sum"`` or ``"mean"`` (divided by M, the zeroed
    diagonal counted, as ``jnp.mean`` counts it)."""
    if reduction not in ("sum", "mean"):
        raise ValueError(f"reduction must be 'sum' or 'mean' here, got {reduction!r}")
    sums = pairwise_reduce(x, y, op=op, zero_diagonal=zero_diagonal)
    if reduction == "mean":
        sums = sums / y.shape[0]
    return sums.to(torch.promote_types(x.dtype, y.dtype))


_registry.register(
    _registry.KernelOp(
        name="pairwise_reduce",
        kernel=_pairwise_cuda,
        plain=_pairwise_plain,
        eligible=_pairwise_eligible,
    )
)

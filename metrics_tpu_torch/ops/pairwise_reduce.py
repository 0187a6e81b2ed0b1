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

Cosine row sums are linear, ``Σ_j x_i·y_j = x_i·(Σ_j y_j)``, so both paths
take that order, in float64: the column sum ``S`` of the rows of ``y`` that
hold no NaN, then ``x_i·S``, less ``x_i·y_i`` when the diagonal is zeroed.
The NaN columns are counted apart, so the NaN pattern is the composition's:
a row's sum is NaN when an unmasked column is NaN or the row itself holds a
NaN (and some column is unmasked), and 0 when every column is masked (one
row against itself). Normalized rows hold no other non-finite value.

The CUDA kernels are in ``csrc/pairwise_reduce.cu`` and have no cap on
``d``. The plain version here forms the euclidean matrix in row chunks of
about 1 GB with ``torch.matmul``; it is the CPU path and the reference on
the card.
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


def _cosine_plain(x: torch.Tensor, y: torch.Tensor, zero_diagonal: bool) -> torch.Tensor:
    """Cosine row sums in the linear order, in float64 (see the module note)."""
    x, y = x.double(), y.double()
    n, m = x.shape[0], y.shape[0]
    nan_col = torch.isnan(y).any(dim=1)
    sums = x @ torch.where(nan_col[:, None], 0.0, y).sum(dim=0)
    nan_cols = torch.full((n,), int(nan_col.sum()), dtype=torch.int64, device=x.device)
    live = torch.full((n,), m, dtype=torch.int64, device=x.device)
    if zero_diagonal:
        k = min(n, m)
        diag = (x[:k] * y[:k]).sum(dim=1)
        sums[:k] -= torch.where(nan_col[:k], 0.0, diag)
        nan_cols[:k] -= nan_col[:k].long()
        live[:k] -= 1
    sums = torch.where(nan_cols > 0, float("nan"), sums)
    return torch.where(live == 0, 0.0, sums)


def _pairwise_plain(x: torch.Tensor, y: torch.Tensor, op: str = "euclidean", zero_diagonal: bool = False) -> torch.Tensor:
    dtype = _sum_dtype(x, y)
    if op == "cosine":
        return _cosine_plain(x, y, zero_diagonal).to(dtype)
    x, y = x.to(dtype), y.to(dtype)
    n, m = x.shape[0], y.shape[0]
    out = torch.empty(n, dtype=dtype, device=x.device)
    y_norm = (y * y).sum(dim=1)[None, :]
    step = max(1, (_PLAIN_BLOCK_ELEMENTS * 4 // dtype.itemsize) // max(m, 1))
    for s in range(0, n, step):
        e = min(s + step, n)
        x_norm = (x[s:e] * x[s:e]).sum(dim=1, keepdim=True)
        vals = ((x_norm + y_norm) - 2 * (x[s:e] @ y.T)).clamp(min=0).sqrt()
        if zero_diagonal and s < m:
            diag = torch.arange(s, min(e, m), device=x.device)
            vals[diag - s, diag] = 0
        out[s:e] = vals.sum(dim=1)
    return out


def _tma_operand(a: torch.Tensor) -> torch.Tensor:
    """``a`` as the euclidean kernel's TMA loads take it: contiguous rows of
    a width that is a multiple of 4 floats (16 bytes), zero-padded (zero
    columns change neither dots nor norms), starting on a 16-byte boundary."""
    pad = (-a.shape[1]) % 4
    if pad:
        return torch.nn.functional.pad(a, (0, pad))
    if not a.is_contiguous() or a.data_ptr() % 16:
        return a.clone(memory_format=torch.contiguous_format)
    return a


def _pairwise_cuda(x: torch.Tensor, y: torch.Tensor, op: str = "euclidean", zero_diagonal: bool = False) -> torch.Tensor:
    lib = _build.library()
    dtype = _sum_dtype(x, y)
    if x.dtype != y.dtype or op == "euclidean":
        # the euclidean tile multiplies float32 (bf16 and fp16 widen exactly)
        x, y = x.to(dtype), y.to(dtype)
    if op == "euclidean" and dtype == torch.float32:
        x, y = _tma_operand(x), _tma_operand(y)
    else:
        x, y = x.contiguous(), y.contiguous()
    (n, d), m = x.shape, y.shape[0]
    out = torch.empty(n, dtype=dtype, device=x.device)
    code, op_code = _DTYPE_CODES[x.dtype], OPS.index(op)
    scratch = torch.empty(lib.mt_pairwise_scratch_bytes(code, op_code, n, m, d), dtype=torch.uint8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.mt_pairwise_reduce(
        x.device.index, code, op_code, x.data_ptr(), y.data_ptr(), n, m, d,
        int(zero_diagonal), out.data_ptr(), scratch.data_ptr(), scratch.numel(), stream,
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

"""Opt-in wire codecs for the cross-process sync (counterpart of
``metrics_tpu/parallel/quantize.py``).

A float state tagged with ``Metric.add_state(sync_precision=)`` may travel
narrow, while integer counts stay exact:

* ``"exact"``, the default: the raw bytes (wire v1), bit-identical end to end.
* ``"bf16"``: the floats cast to bfloat16 (round to nearest even) on the
  wire and back to the state's dtype on receipt; half the bytes of float32.
  Per element, ``|x̂ - x| <= 2**-8 * |x|``; ±Inf and NaN round-trip.
* ``"int8"``: symmetric per-block quantization: the flattened state in
  blocks of :data:`INT8_BLOCK` elements, each with one float32 scale
  (``absmax / 127``) and int8 codes; about 3.9x fewer bytes than float32.
  Per element, ``|x̂ - x| <= absmax_block / 254``. Non-finite values clip
  to the code range (NaN to code 0).

One pair of functions serves both sync paths: :func:`quantize_array` and
:func:`dequantize_array` run on whatever device their tensor lies on, on
CPU tensors for the store wire (``parallel/groups.py``) and on the state's
device for a ``torch.distributed`` ``all_gather`` of the codes
(``parallel/comm.py``). Codes and scales equal the JAX package's numpy codec
bit for bit: the int8 division is the same float32 ``blocks / scales``, and
both round half to even. torch writes every NaN as bfloat16 ``0xFFFF``;
the JAX wire (ml_dtypes) writes ``0x7FC0`` with the NaN's sign, so the bf16
codec writes that too, and a payload of a state with NaN is byte-identical.

The module also keeps the process-wide wire counters (:func:`wire_stats`)
that ``obs.snapshot()["wire"]`` and the ``metrics_tpu_wire_*`` Prometheus
families read.
"""
import threading
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

#: Valid ``sync_precision`` tags (requested codecs).
CODECS = ("exact", "bf16", "int8")

#: Elements per int8 quantization block (one float32 scale per block).
INT8_BLOCK = 256

# bfloat16 bit patterns of a quiet NaN, as ml_dtypes writes them: 0x7FC0 and,
# with the sign bit, 0xFFC0 (as int16)
_BF16_NAN = 0x7FC0
_BF16_NEG_NAN = 0xFFC0 - 0x10000

#: dtype names of the wire header (numpy's ``dtype.name``, and ``bfloat16``)
_TORCH_BY_NAME: Dict[str, torch.dtype] = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}
for _name in ("uint16", "uint32", "uint64"):
    if hasattr(torch, _name):
        _TORCH_BY_NAME[_name] = getattr(torch, _name)
_NAME_BY_TORCH = {v: k for k, v in _TORCH_BY_NAME.items()}


def dtype_name(dtype: Any) -> str:
    """The wire header's name of a torch, numpy or named dtype."""
    if isinstance(dtype, torch.dtype):
        try:
            return _NAME_BY_TORCH[dtype]
        except KeyError:
            raise TypeError(f"the sync wire cannot carry dtype {dtype}") from None
    if isinstance(dtype, str) and dtype == "bfloat16":
        return dtype
    return np.dtype(dtype).name


def torch_dtype(name: Any) -> torch.dtype:
    """The torch dtype of a wire header's dtype name (or of any dtype)."""
    if isinstance(name, torch.dtype):
        return name
    key = name if isinstance(name, str) else np.dtype(name).name
    if key not in _TORCH_BY_NAME:
        key = np.dtype(key).name  # aliases such as "f4" or "<i8"
    try:
        return _TORCH_BY_NAME[key]
    except KeyError:
        raise TypeError(f"the sync wire cannot carry dtype {name!r}") from None


def _is_float_dtype(dtype: Any) -> bool:
    """True for every float family the wire may carry: float16/32/64 and
    bfloat16, as torch, numpy or named dtypes."""
    try:
        return torch_dtype(dtype).is_floating_point
    except TypeError:
        return False


def resolve_codec(precision: Optional[str], dtype: Any) -> str:
    """The codec a payload of ``dtype`` rides under ``precision``: None and
    ``"exact"`` are exact, and so is a quantized tag on an integer or bool
    payload (counts stay bit-identical)."""
    if precision is None or precision == "exact":
        return "exact"
    if precision not in CODECS:
        raise ValueError(f"`sync_precision` must be one of {CODECS}, got {precision!r}")
    return precision if _is_float_dtype(dtype) else "exact"


def _block_count(n: int) -> int:
    return -(-n // INT8_BLOCK) if n else 0


def as_tensor(x: Any) -> torch.Tensor:
    """``x`` as a tensor: a tensor as it is, an array (of any byte order) or
    a scalar as a CPU tensor of its dtype."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x, order="C")
    arr = arr.astype(arr.dtype.newbyteorder("="), copy=False)
    return torch.from_numpy(np.array(arr, copy=True))


def _bf16_codes(x: torch.Tensor) -> torch.Tensor:
    """``x`` as bfloat16 with every NaN written ``0x7FC0`` or ``0xFFC0``."""
    bits = x.to(torch.bfloat16).view(torch.int16)
    nan_bits = torch.where(
        torch.signbit(x),
        torch.full((), _BF16_NEG_NAN, dtype=torch.int16, device=x.device),
        torch.full((), _BF16_NAN, dtype=torch.int16, device=x.device),
    )
    return torch.where(torch.isnan(x), nan_bits, bits).view(torch.bfloat16)


def quantize_array(x: Any, codec: str) -> Tuple[torch.Tensor, Optional[torch.Tensor], Dict[str, Any]]:
    """Encode ``x`` under ``codec`` on its device: ``(qdata, scales, meta)``.

    ``scales`` is None except for int8 (one float32 per
    :data:`INT8_BLOCK`-element block); ``meta`` is what the receiver needs
    beyond the dtype and shape: ``codec`` and, for int8, the block size.
    Only the true element count of codes is kept: the last block's padding
    decodes as zeros."""
    x = as_tensor(x)
    if codec == "exact":
        return x, None, {"codec": "exact"}
    if codec == "bf16":
        return _bf16_codes(x), None, {"codec": "bf16"}
    if codec == "int8":
        flat = x.to(torch.float32).reshape(-1)
        n = flat.numel()
        nblocks = _block_count(n)
        padded = torch.zeros(nblocks * INT8_BLOCK, dtype=torch.float32, device=x.device)
        padded[:n] = flat
        blocks = padded.reshape(nblocks, INT8_BLOCK)
        if nblocks:
            absmax = blocks.abs().amax(dim=1)
        else:
            absmax = torch.zeros((0,), dtype=torch.float32, device=x.device)
        # zero and non-finite blocks take a neutral scale of 1.0
        safe = torch.where(torch.isfinite(absmax) & (absmax > 0), absmax, torch.ones_like(absmax))
        # a tensor divisor: CUDA divides by a Python scalar through its
        # reciprocal, which rounds some scales differently from numpy's
        scales = safe / torch.full_like(safe, 127.0)
        q = torch.clamp(torch.round(blocks / scales[:, None]), -127, 127)
        q = torch.where(torch.isnan(q), torch.zeros_like(q), q).to(torch.int8)
        return q.reshape(-1)[:n], scales, {"codec": "int8", "block": INT8_BLOCK}
    raise ValueError(f"Unknown wire codec {codec!r}; must be one of {CODECS}")


def dequantize_array(
    qdata: torch.Tensor,
    scales: Optional[torch.Tensor],
    codec: str,
    dtype: Any,
    shape: Tuple[int, ...],
) -> torch.Tensor:
    """Decode a :func:`quantize_array` payload back to ``dtype`` and
    ``shape``, on ``qdata``'s device."""
    dtype = torch_dtype(dtype)
    shape = tuple(int(d) for d in shape)
    if codec == "exact":
        return qdata.reshape(shape)
    if codec == "bf16":
        return qdata.to(dtype).reshape(shape)
    if codec == "int8":
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if n == 0:
            return torch.zeros(shape, dtype=dtype, device=qdata.device)
        nblocks = _block_count(n)
        codes = torch.zeros(nblocks * INT8_BLOCK, dtype=torch.float32, device=qdata.device)
        codes[:n] = qdata.reshape(-1)[:n].to(torch.float32)
        out = (codes.reshape(nblocks, INT8_BLOCK) * scales.to(torch.float32)[:, None]).reshape(-1)[:n]
        return out.reshape(shape).to(dtype)
    raise ValueError(f"Unknown wire codec {codec!r}; must be one of {CODECS}")


def error_bound(codec: str, absmax: float) -> float:
    """The documented per-element error bound of ``codec`` on a payload
    whose largest magnitude is ``absmax``."""
    if codec == "exact":
        return 0.0
    if codec == "bf16":
        return float(absmax) * 2.0**-8
    if codec == "int8":
        return float(absmax) / 254.0
    raise ValueError(f"Unknown wire codec {codec!r}; must be one of {CODECS}")


def nbytes(x: torch.Tensor) -> int:
    return int(x.numel()) * int(x.element_size())


# ---------------------------------------------------------------------------
# process-wide wire telemetry
# ---------------------------------------------------------------------------
_stats_lock = threading.Lock()


def _fresh_stats() -> Dict[str, Any]:
    return {
        "bytes_raw": 0,
        "bytes_encoded": 0,
        "bytes_raw_quantized": 0,
        "bytes_encoded_quantized": 0,
        "codec_counts": {codec: 0 for codec in CODECS},
        "max_dequant_error": 0.0,
    }


_WIRE_STATS = _fresh_stats()


def record_wire(
    codec: str,
    bytes_raw: int,
    bytes_encoded: int,
    error: Union[float, int] = 0.0,
    stats: Optional[Dict[str, Any]] = None,
) -> None:
    """Count one encoded payload into the process-wide wire counters and,
    when given, into a sync ``stats`` dict (a metric's ``sync_report()``)."""
    targets = [_WIRE_STATS] if stats is None else [_WIRE_STATS, stats]
    with _stats_lock:
        for target in targets:
            target["bytes_raw"] = target.get("bytes_raw", 0) + int(bytes_raw)
            target["bytes_encoded"] = target.get("bytes_encoded", 0) + int(bytes_encoded)
            if codec != "exact":
                target["bytes_raw_quantized"] = target.get("bytes_raw_quantized", 0) + int(bytes_raw)
                target["bytes_encoded_quantized"] = target.get("bytes_encoded_quantized", 0) + int(bytes_encoded)
            counts = target.setdefault("codec_counts", {c: 0 for c in CODECS})
            counts[codec] = counts.get(codec, 0) + 1
            if error:
                target["max_dequant_error"] = max(target.get("max_dequant_error", 0.0), float(error))


def wire_stats() -> Dict[str, Any]:
    """A copy of the process-wide wire counters: codec-level ``bytes_raw``
    and ``bytes_encoded`` over every encoded leaf (envelope and header
    excluded, so their ratio is the codec's), the same split over quantized
    payloads (``*_quantized``), per-codec ``codec_counts`` and the largest
    round-trip ``max_dequant_error`` seen."""
    with _stats_lock:
        out = dict(_WIRE_STATS)
        out["codec_counts"] = dict(_WIRE_STATS["codec_counts"])
        return out


def reset_wire_stats() -> None:
    with _stats_lock:
        _WIRE_STATS.clear()
        _WIRE_STATS.update(_fresh_stats())

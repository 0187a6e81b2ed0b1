"""Builds the CUDA kernels in ``csrc/`` at first use and loads them with ctypes.

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a``; the objects are linked into one shared library with a plain
C interface in ``metrics_tpu_torch/_build/`` (or in the persistent kernel
cache's directory, ``engine/persist.py``), named by a hash of the sources
and flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing here includes PyTorch's headers, which keeps a build to seconds.

A failed build raises; there is no plain-version fallback.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("binned_counts.cu", "confusion_counts.cu", "mark.cu", "pairwise_reduce.cu", "select_topk.cu")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
#: C entry -> argument types. Every entry returns ``cudaGetLastError()`` as int.
_SIGNATURES: Dict[str, List] = {
    # device, target, preds (int32 or int64 [N]), n, num_classes, bytes per index,
    # histograms per block (0: the global route), out [C*C] u64, stream
    "mt_confusion_counts": [_INT, _P, _P, _I64, _I64, _I64, _I64, _INT, _INT, _P, _P],
    # device, preds i32 [N*C], target i32 [N*C], n, c, lanes per row, 16-byte loads,
    # out i64 [C*4] ([[tn, fp], [fn, tp]] per class), stream
    "mt_multilabel_counts": [_INT, _P, _P, _I64, _I64, _I64, _INT, _INT, _P, _P],
    # device, x f32 [N*C], n, c, k, out i32 [N*C], stream
    "mt_topk_mask": [_INT, _P, _I64, _I64, _INT, _P, _P],
    # device, x f64 [N*C], n, c, k, out i32 [N*C], stream
    "mt_topk_mask_f64": [_INT, _P, _I64, _I64, _INT, _P, _P],
    # device, x f32 [N*C], n, c, k, keys per lane, 16-byte loads, out i32 [N*C], stream
    "mt_topk_mask_regs": [_INT, _P, _I64, _I64, _INT, _INT, _INT, _P, _P],
    # device, preds f32 [N*C], target i32 [N*C], ths f32 [T], n, c, t,
    # out i64 [4*C*T] (TP, FP, FN, TN), scratch, scratch bytes, stream
    "mt_binned_counts_f32": [_INT, _P, _P, _P, _I64, _I64, _I64, _P, _P, _I64, _P],
    # the same with preds and ths f64
    "mt_binned_counts_f64": [_INT, _P, _P, _P, _I64, _I64, _I64, _P, _P, _I64, _P],
    # device, conf f32 [N], acc f32 [N], bounds f32 [B+1], n, bins, route, K, 16-byte loads,
    # out (count i64 [B], conf_sum f32 [B], acc_sum f32 [B]), scratch, scratch bytes, stream
    "mt_binned_calibration": [_INT, _P, _P, _P, _I64, _I64, _INT, _INT, _INT, _P, _P, _I64, _P],
    # device, dtype code, op code, x [N*d], y [M*d], n, m, d, zero_diag,
    # out [N] (f64 for f64 inputs, else f32), scratch, scratch bytes, stream
    "mt_pairwise_reduce": [_INT, _INT, _INT, _P, _P, _I64, _I64, _I64, _INT, _P, _P, _I64, _P],
    # device, stage (index in obs/trace.py MARK_STAGES), stream
    "mt_mark": [_INT, _INT, _P],
}
#: C entries that return a value other than an error code: name -> (argument types, result type).
_QUERIES: Dict[str, tuple] = {
    # dtype code, op code, n, m, d -> bytes of scratch mt_pairwise_reduce needs
    "mt_pairwise_scratch_bytes": ([_INT, _INT, _I64, _I64, _I64], _I64),
    # device, route, K, bins -> bytes of scratch mt_binned_calibration needs
    "mt_binned_calibration_scratch_bytes": ([_INT, _INT, _INT, _I64], _I64),
    # n, c, t, bytes per pred -> bytes of scratch mt_binned_counts_f32/_f64 need
    "mt_binned_counts_scratch_bytes": ([_I64, _I64, _I64, _I64], _I64),
}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
#: Seconds the last build in this process took (0.0 when the library was reused).
last_build_seconds = 0.0
#: Compiler output (``-Xptxas -v``: registers and shared memory per kernel).
last_build_log = ""


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH)")


def _build_dir() -> Path:
    """``BUILD_DIR``, or the persistent kernel cache's directory where one is enabled."""
    from metrics_tpu_torch.engine import persist

    path = persist.cache_dir()
    return BUILD_DIR if path is None else Path(path)


def _library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        digest.update((CSRC / src).read_bytes())
    return _build_dir() / f"libmetrics_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/`` into the shared library unless it is already built."""
    global last_build_seconds, last_build_log
    from metrics_tpu_torch.engine import persist

    so = _library_path()
    if so.exists():
        last_build_seconds = 0.0
        persist.note_load(built=False)
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(dir=so.parent))
    try:
        objs = [work / (Path(src).stem + ".o") for src in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(SOURCES, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        failed = [(src, log) for src, p, log in zip(SOURCES, procs, logs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(f"--- {s}\n{log}" for s, log in failed))
        tmp_so = work / so.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, so)  # atomic: a concurrent build sees all or nothing
    finally:
        shutil.rmtree(work, ignore_errors=True)
    last_build_seconds = time.perf_counter() - t0
    last_build_log = "\n".join(logs)
    persist.note_load(built=True)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _INT
            for name, (argtypes, restype) in _QUERIES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            lib.mt_error_string.argtypes = [_INT]
            lib.mt_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} ({lib.mt_error_string(err).decode()})")

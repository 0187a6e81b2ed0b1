"""Builds the CUDA kernels in ``csrc/`` at first use and loads them with ctypes.

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a``; the objects are linked into one shared library with a plain
C interface in ``metrics_tpu_torch/_build/``, named by a hash of the sources
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
SOURCES = ("binned_counts.cu", "confusion_counts.cu", "select_topk.cu")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
#: C entry -> argument types. Every entry returns ``cudaGetLastError()`` as int.
_SIGNATURES: Dict[str, List] = {
    # device, target, preds, n, num_classes, out [C*C] u64, stream
    "mt_confusion_counts": [_INT, _P, _P, _I64, _I64, _P, _P],
    # device, preds, target, n, c, out [C*3] u64, stream
    "mt_multilabel_counts": [_INT, _P, _P, _I64, _I64, _P, _P],
    # device, x f32 [N*C], n, c, k, out i32 [N*C], stream
    "mt_topk_mask": [_INT, _P, _I64, _I64, _INT, _P, _P],
    # device, x f64 [N*C], n, c, k, out i32 [N*C], stream
    "mt_topk_mask_f64": [_INT, _P, _I64, _I64, _INT, _P, _P],
    # device, preds f32 [N*C], target i32 [N*C], ths f32 [T], n, c, t,
    # tp u64 [C*T], fp u64 [C*T], pos u64 [C], stream
    "mt_binned_counts_f32": [_INT, _P, _P, _P, _I64, _I64, _I64, _P, _P, _P, _P],
    # the same with preds and ths f64
    "mt_binned_counts_f64": [_INT, _P, _P, _P, _I64, _I64, _I64, _P, _P, _P, _P],
    # device, conf f32 [N], acc f32 [N], bounds f32 [B+1], n, bins,
    # count u64 [B], conf_sum f32 [B], acc_sum f32 [B], stream
    "mt_binned_calibration": [_INT, _P, _P, _P, _I64, _I64, _P, _P, _P, _P],
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


def _library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        digest.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"libmetrics_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/`` into the shared library unless it is already built."""
    global last_build_seconds, last_build_log
    so = _library_path()
    if so.exists():
        last_build_seconds = 0.0
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
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
            lib.mt_error_string.argtypes = [_INT]
            lib.mt_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err} ({lib.mt_error_string(err).decode()})")

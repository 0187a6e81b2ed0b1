"""The least time a kernel call could take, from the bytes its inputs need.

Both kernels measured here are bound by bytes, so the least time is the
bytes over the card's HBM rate: 3.35 TB/s, the NVIDIA H100 SXM data sheet
(the rate assumes the full 700 W power limit; the run prints the card's).
Each input byte is counted read once and each output byte written once.
"""
import torch

HBM_BYTES_PER_S = 3.35e12

CONFUSION_KERNELS = ("confusion_counts_kernel", "confusion_shared_kernel")
TOPK_KERNELS = ("topk_mask",)


def confusion_counts_bytes(n: int, index_bytes: int, cells_touched: int) -> int:
    """``confusion_counts`` on ``n`` (target, pred) pairs: both index vectors
    read once, and one 8-byte count written for each distinct ``[C, C]``
    cell the pairs touch. The wrapper's zero-fill of the whole matrix is
    not the kernel's work and is not in the kernel's time."""
    return 2 * n * index_bytes + 8 * cells_touched


def select_topk_bytes(n: int, c: int, score_bytes: int = 4) -> int:
    """``select_topk`` on ``[n, c]`` scores: the scores read once and the
    ``[n, c]`` int32 mask written once."""
    return n * c * (score_bytes + 4)


def cells_touched(target: torch.Tensor, pred: torch.Tensor, c: int) -> int:
    """The distinct ``(target, pred)`` cells among the pairs."""
    keys = target.reshape(-1).to(torch.int64) * c + pred.reshape(-1).to(torch.int64)
    return int(torch.unique(keys).numel())


def least_seconds(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S


def roofline_pct(n_bytes: float, kernel_s: float):
    """Share of the bytes' least time in the measured kernel time, in %;
    None where the kernel did not run."""
    if kernel_s <= 0 or n_bytes <= 0:
        return None
    return 100.0 * least_seconds(n_bytes) / kernel_s

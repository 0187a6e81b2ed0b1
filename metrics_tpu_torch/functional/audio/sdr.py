"""SDR and SI-SDR (counterpart of ``metrics_tpu/functional/audio/sdr.py``).

SDR is the filter-invariant SDR of Scheibler, "SDR — Medium Rare with Fast
Computations" (2021), as in the JAX package:

1. optionally subtract the means, then normalize both signals along time;
2. the autocorrelation of ``target`` and the cross-correlation of
   ``target`` and ``preds`` at lags ``0..L-1``, by real FFTs at the power of
   two at least twice the length;
3. solve the symmetric Toeplitz system ``R sol = xcorr`` (``R[i, j] =
   acf[|i - j|]``) for the optimal distortion filter, batched over the
   leading axes;
4. ``coh = xcorr · sol`` and ``SDR = 10 log10(coh / (1 - coh))``.

The solve is ``torch.linalg.solve_ex``: it leaves a singular system's
``inf``/``nan`` in place, as ``jnp.linalg.solve`` does, without the host
read of ``info`` that ``torch.linalg.solve`` makes, so an update that runs it
can be captured (on the H100, MAGMA's batched LU still syncs inside a
capture, so there the update runs eagerly). The products run with TF32
off. In float32 the result loses digits as SDR rises, since ``1 - coh``
cancels.
"""
from typing import Optional

import torch

from metrics_tpu_torch.image.networks._common import full_fp32
from metrics_tpu_torch.utils.checks import _check_same_shape


def _as_float(preds: torch.Tensor, target: torch.Tensor):
    """``preds`` promoted to at least float32 (half and bfloat16 go to
    float32, float64 stays), ``target`` in the same dtype."""
    preds = torch.as_tensor(preds)
    preds = preds.to(torch.promote_types(preds.dtype, torch.float32))
    return preds, torch.as_tensor(target, device=preds.device).to(preds.dtype)


def _fft_next_size(n: int) -> int:
    """Smallest power of two >= 2n (linear, not circular, correlation)."""
    size = 1
    while size < 2 * n:
        size *= 2
    return size


def _auto_cross_corr(target: torch.Tensor, preds: torch.Tensor, corr_len: int):
    """Autocorrelation of ``target`` and cross-correlation ``target * preds``
    at lags ``0..corr_len-1`` via real FFT."""
    n_fft = _fft_next_size(target.shape[-1])
    t_f = torch.fft.rfft(target, n=n_fft, dim=-1)
    p_f = torch.fft.rfft(preds, n=n_fft, dim=-1)
    acf = torch.fft.irfft(torch.abs(t_f) ** 2, n=n_fft, dim=-1)[..., :corr_len]
    xcorr = torch.fft.irfft(torch.conj(t_f) * p_f, n=n_fft, dim=-1)[..., :corr_len]
    return acf, xcorr


def signal_distortion_ratio(
    preds: torch.Tensor,
    target: torch.Tensor,
    use_cg_iter: Optional[int] = None,
    filter_length: int = 512,
    zero_mean: bool = False,
    load_diag: Optional[float] = None,
) -> torch.Tensor:
    """Filter-invariant SDR, shape ``[..., time] -> [...]``.

    Args:
        preds / target: time signals (time on the last axis).
        use_cg_iter: accepted for API parity and ignored: the system is
            solved directly.
        filter_length: allowed length of the distortion filter, at most the
            signal length.
        zero_mean: subtract per-signal means first.
        load_diag: Tikhonov loading added to the Toeplitz diagonal for
            stability when references can be (near-)zero.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import signal_distortion_ratio
        >>> g = torch.Generator().manual_seed(0)
        >>> target = torch.randn(1000, generator=g)
        >>> preds = target + 0.01 * torch.randn(1000, generator=g)
        >>> print(float(signal_distortion_ratio(preds, target)) > 30.0)
        True
    """
    preds, target = _as_float(preds, target)
    _check_same_shape(preds, target)
    # the distortion filter cannot be longer than the signal itself: clamp to
    # keep the Toeplitz system full-rank (and the FFT slice in range)
    filter_length = min(filter_length, preds.shape[-1])
    eps = torch.finfo(preds.dtype).eps

    if zero_mean:
        preds = preds - preds.mean(dim=-1, keepdim=True)
        target = target - target.mean(dim=-1, keepdim=True)

    preds = preds / torch.clamp(torch.linalg.vector_norm(preds, dim=-1, keepdim=True), min=eps)
    target = target / torch.clamp(torch.linalg.vector_norm(target, dim=-1, keepdim=True), min=eps)

    acf, xcorr = _auto_cross_corr(target, preds, filter_length)
    if load_diag is not None:
        acf = torch.cat([acf[..., :1] + load_diag, acf[..., 1:]], dim=-1)

    lags = torch.arange(filter_length, device=acf.device)
    r_mat = acf[..., torch.abs(lags[:, None] - lags[None, :])]
    with full_fp32():
        sol = torch.linalg.solve_ex(r_mat, xcorr[..., None])[0][..., 0]
        coh = torch.einsum("...l,...l->...", xcorr, sol)
    return 10.0 * torch.log10(coh / (1 - coh))


def scale_invariant_signal_distortion_ratio(
    preds: torch.Tensor, target: torch.Tensor, zero_mean: bool = False
) -> torch.Tensor:
    """SI-SDR (Le Roux et al. 2019), shape ``[..., time] -> [...]``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import scale_invariant_signal_distortion_ratio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> print(round(float(scale_invariant_signal_distortion_ratio(preds, target)), 4))
        18.403
    """
    preds, target = _as_float(preds, target)
    _check_same_shape(preds, target)
    eps = torch.finfo(preds.dtype).eps

    if zero_mean:
        target = target - target.mean(dim=-1, keepdim=True)
        preds = preds - preds.mean(dim=-1, keepdim=True)

    alpha = (torch.sum(preds * target, dim=-1, keepdim=True) + eps) / (
        torch.sum(target**2, dim=-1, keepdim=True) + eps
    )
    target_scaled = alpha * target
    noise = target_scaled - preds
    val = (torch.sum(target_scaled**2, dim=-1) + eps) / (torch.sum(noise**2, dim=-1) + eps)
    return 10 * torch.log10(val)

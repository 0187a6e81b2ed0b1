"""Short-Time Objective Intelligibility (counterpart of
``metrics_tpu/functional/audio/stoi.py``): native STOI and ESTOI (Taal et
al. 2011; Jensen & Taal 2016), with no ``pystoi``, batched over the leading
axes:

1. **Polyphase resampling to 10 kHz**, scipy's ``resample_poly`` with the
   Octave-compatible Kaiser filter: the input is zero-inserted (the
   upsampling factor), padded and correlated with the taps at a stride of
   the downsampling factor, one ``conv1d``, with TF32 off.
2. **Silent-frame removal (40 dB)** with fixed shapes: the kept frames are
   gathered to the front in order (a ``searchsorted`` of the running count
   of kept frames gives the frame of each slot) and overlap-added, each
   output block of 128 samples the sum of the at most two kept frames that
   cover it. There is no scatter-add, so the sum has one order and an
   update that runs it can be captured.
3. **STFT** (256-sample Hann frames, hop 128, 512-point rFFT) over the fixed
   buffer; frames past the kept ones are masked downstream.
4. **15 one-third octave bands** by one product with the band matrix, TF32
   off.
5. **384 ms segments** (30 frames, sliding): clipped-correlation STOI or
   row- and column-normalized ESTOI, averaged over the valid segments.

Too-short signals (fewer than 30 valid frames after silence removal) give
the pystoi sentinel ``1e-5``.
"""
import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from metrics_tpu_torch.image.networks._common import full_fp32
from metrics_tpu_torch.utils.checks import _check_same_shape

_FS = 10000
_FRAME = 256
_HOP = 128
_NFFT = 512
_NUM_BANDS = 15
_MIN_FREQ = 150
_SEG = 30  # frames per intermediate-intelligibility segment (384 ms)
_BETA = -15.0  # clipping floor in dB
_DYN_RANGE = 40.0
_EPS = float(np.finfo(np.float64).eps)
_SHORT = 1e-5  # the score of a signal too short to hold one segment


def _hann_interior(n: int) -> np.ndarray:
    """Interior of an (n+2)-point Hann window — the STOI framing window."""
    return np.hanning(n + 2)[1:-1]


def _octave_band_matrix() -> np.ndarray:
    """[15, 257] one-third octave aggregation matrix over rFFT bins."""
    f = np.linspace(0, _FS, _NFFT + 1)[: _NFFT // 2 + 1]
    k = np.arange(_NUM_BANDS, dtype=float)
    freq_low = _MIN_FREQ * 2.0 ** ((2 * k - 1) / 6)
    freq_high = _MIN_FREQ * 2.0 ** ((2 * k + 1) / 6)
    obm = np.zeros((_NUM_BANDS, len(f)))
    for i in range(_NUM_BANDS):
        lo = int(np.argmin(np.square(f - freq_low[i])))
        hi = int(np.argmin(np.square(f - freq_high[i])))
        obm[i, lo:hi] = 1
    return obm


@lru_cache(maxsize=None)
def _resample_plan(up: int, down: int) -> Tuple[np.ndarray, int, int, int]:
    """Filter taps and slicing offset reproducing scipy ``resample_poly`` with
    the Octave-compatible Kaiser anti-aliasing filter (the design pystoi uses).

    Returns ``(taps, up, down, n_pre_remove)`` where ``taps`` already includes
    the gain ``up`` and scipy's pre-pad zeros, and is flipped for a
    correlation.
    """
    g = math.gcd(up, down)
    up, down = up // g, down // g
    stopband_cutoff = 1.0 / (2 * max(up, down))
    rejection_db = 60.0
    half_len = int(np.ceil(rejection_db / (22 * (stopband_cutoff / 10))))
    t = np.arange(-half_len, half_len + 1)
    ideal = 2 * up * stopband_cutoff * np.sinc(2 * stopband_cutoff * t)
    beta = 0.1102 * (rejection_db - 8.7)
    h = np.kaiser(2 * half_len + 1, beta) * ideal
    h = h / np.sum(h) * up
    n_pre_pad = down - half_len % down
    h = np.concatenate([np.zeros(n_pre_pad), h])
    n_pre_remove = (half_len + n_pre_pad) // down
    return h[::-1].copy(), up, down, n_pre_remove


@lru_cache(maxsize=None)
def _constant(name: str, fs_in: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The taps (``"taps"``, of the ``fs_in`` plan), the framing window
    (``"window"``) or the band matrix (``"bands"``) on ``device``, made once:
    a captured update reads it and never copies it from the host."""
    if name == "taps":
        value = _resample_plan(_FS, fs_in)[0]
    elif name == "window":
        value = _hann_interior(_FRAME)
    else:
        value = _octave_band_matrix()
    return torch.from_numpy(np.ascontiguousarray(value)).to(device=device, dtype=dtype)


def _resample(x: torch.Tensor, fs_in: int) -> torch.Tensor:
    """Polyphase resample ``[..., T] -> [..., ceil(T * 10000 / fs_in)]``:
    the zero-inserted input correlated with the taps at stride ``down``."""
    _, up, down, n_pre_remove = _resample_plan(_FS, fs_in)
    taps = _constant("taps", fs_in, x.dtype, x.device)
    n_in = x.shape[-1]
    n_out = -(-n_in * up // down)
    lead = x.shape[:-1]
    flat = x.reshape(-1, n_in)
    dilated = flat.new_zeros((flat.shape[0], (n_in - 1) * up + 1))
    dilated[:, ::up] = flat
    pad = taps.shape[0] - 1
    with full_fp32():
        out = F.conv1d(F.pad(dilated, (pad, pad))[:, None, :], taps[None, None, :], stride=down)
    return out[:, 0, n_pre_remove : n_pre_remove + n_out].reshape(lead + (n_out,))


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _row_col_normalize(segs: torch.Tensor) -> torch.Tensor:
    """ESTOI normalization of ``[B, M, J, N]`` segments: rows (time), then
    columns (bands), per segment."""
    segs = segs - segs.mean(dim=-1, keepdim=True)
    segs = segs / (torch.linalg.vector_norm(segs, dim=-1, keepdim=True) + _EPS)
    segs = segs - segs.mean(dim=-2, keepdim=True)
    return segs / (torch.linalg.vector_norm(segs, dim=-2, keepdim=True) + _EPS)


def _remove_silent_frames(x: torch.Tensor, y: torch.Tensor, window: torch.Tensor):
    """``x`` and ``y`` ``[B, n]`` with the frames more than 40 dB below the
    loudest frame of ``x`` left out: the kept frames in order, overlap-added
    at hop 128 into a fixed ``[B, n_sil_max]`` buffer, zero past them; and
    the number of kept frames per signal."""
    xf = x.unfold(-1, _FRAME, _HOP) * window  # [B, F, FRAME]; frame starts <= n - FRAME
    yf = y.unfold(-1, _FRAME, _HOP) * window
    n_frames = xf.shape[1]
    energies = 20 * torch.log10(torch.linalg.vector_norm(xf, dim=-1) + _EPS)
    keep = energies > energies.amax(dim=-1, keepdim=True) - _DYN_RANGE
    running = torch.cumsum(keep, dim=-1)  # kept frames up to and including each frame
    num_kept = running[:, -1]
    slots = torch.arange(1, n_frames + 1, device=x.device)
    # the frame that fills slot s: the first frame whose running count reaches s + 1
    frame_of_slot = torch.searchsorted(running, slots.expand(x.shape[0], n_frames).contiguous())
    filled = (slots[None, :] <= num_kept[:, None])[..., None]
    index = frame_of_slot.clamp(max=n_frames - 1)[..., None]
    out = []
    for frames in (xf, yf):
        kept = torch.where(filled, torch.take_along_dim(frames, index, dim=1), 0.0)
        # block q of 128 samples: the first half of slot q plus the second half of slot q - 1
        blocks = F.pad(kept[..., :_HOP], (0, 0, 0, 1)) + F.pad(kept[..., _HOP:], (0, 0, 1, 0))
        out.append(blocks.reshape(x.shape[0], (n_frames + 1) * _HOP))
    return out[0], out[1], num_kept


def _stoi_batch(x: torch.Tensor, y: torch.Tensor, extended: bool) -> torch.Tensor:
    """STOI of each (clean ``x[b]``, processed ``y[b]``) pair, ``[B, n]`` at 10 kHz."""
    n = x.shape[-1]
    dtype, device = x.dtype, x.device
    short = torch.full((x.shape[0],), _SHORT, dtype=dtype, device=device)
    # framing here is last-start-inclusive (start <= n - framelen), while the
    # STFT below is strict (start < n - framelen): the pystoi conventions
    n_frames = (n - _FRAME) // _HOP + 1
    if n_frames <= 0:
        return short
    window = _constant("window", _FS, dtype, device)
    x_sil, y_sil, num_kept = _remove_silent_frames(x, y, window)

    # STFT over the fixed buffer; valid frames = K - 1
    t_max = (x_sil.shape[-1] - _FRAME - 1) // _HOP + 1
    if t_max < _SEG:
        return short
    bands = _constant("bands", _FS, dtype, device)
    tob = []
    for sig in (x_sil, y_sil):
        spec = torch.fft.rfft(sig.unfold(-1, _FRAME, _HOP)[:, :t_max] * window, n=_NFFT)  # [B, T, F]
        with full_fp32():
            tob.append(torch.sqrt(torch.abs(spec) ** 2 @ bands.T).transpose(1, 2))  # [B, J, T]

    # sliding segments of 30 frames: [B, M, J, N]
    x_segs, y_segs = (t.unfold(-1, _SEG, 1).transpose(1, 2) for t in tob)
    m_max = t_max - _SEG + 1
    m_valid = torch.clamp(num_kept - 1 - _SEG + 1, min=0)  # valid segments
    seg_mask = (torch.arange(m_max, device=device)[None, :] < m_valid[:, None]).to(dtype)  # [B, M]
    denom = torch.clamp(m_valid, min=1)

    if extended:
        x_n = _row_col_normalize(x_segs)
        y_n = _row_col_normalize(y_segs)
        per_seg = torch.sum(x_n * y_n, dim=(-2, -1)) / _SEG  # [B, M]
        d = torch.sum(per_seg * seg_mask, dim=-1) / denom
    else:
        norm_const = _norm(x_segs) / (_norm(y_segs) + _EPS)
        y_prime = torch.minimum(y_segs * norm_const, x_segs * (1 + 10 ** (-_BETA / 20)))
        y_prime = y_prime - y_prime.mean(dim=-1, keepdim=True)
        x_c = x_segs - x_segs.mean(dim=-1, keepdim=True)
        y_prime = y_prime / (_norm(y_prime) + _EPS)
        x_c = x_c / (_norm(x_c) + _EPS)
        per_seg = torch.sum(x_c * y_prime, dim=(-2, -1))  # [B, M] (summed over bands)
        d = torch.sum(per_seg * seg_mask, dim=-1) / (denom * _NUM_BANDS)
    return torch.where(m_valid >= 1, d, short)


def short_time_objective_intelligibility(
    preds: torch.Tensor,
    target: torch.Tensor,
    fs: int,
    extended: bool = False,
    keep_same_device: bool = False,
) -> torch.Tensor:
    """STOI score per sample, shape ``[..., time] -> [...]``, on the inputs' device.

    ``target`` is the clean reference, ``preds`` the processed signal.
    ``keep_same_device`` is accepted for API parity and ignored: the whole
    computation runs on the input's device. Integer PCM is promoted to
    float32 at least.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import short_time_objective_intelligibility
        >>> g = torch.Generator().manual_seed(1)
        >>> target = torch.randn(8000, generator=g)
        >>> preds = target + 0.1 * torch.randn(8000, generator=g)
        >>> print(float(short_time_objective_intelligibility(preds, target, 8000)) > 0.5)
        True
    """
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target, device=preds.device)
    _check_same_shape(preds, target)
    # common float dtype: integer PCM input must not poison the windows/taps
    dtype = torch.promote_types(torch.promote_types(preds.dtype, target.dtype), torch.float32)
    lead = preds.shape[:-1]
    p2 = preds.to(dtype).reshape(-1, preds.shape[-1])
    t2 = target.to(dtype).reshape(-1, target.shape[-1])
    if fs != _FS:
        p2 = _resample(p2, fs)
        t2 = _resample(t2, fs)
    return _stoi_batch(t2, p2, extended).reshape(lead)

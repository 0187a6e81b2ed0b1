"""PESQ (counterpart of ``metrics_tpu/functional/audio/pesq.py``). The ITU-T
P.862 algorithm comes from the C-backed ``pesq`` wheel and runs per sample
on the host; the wheel is optional, so this is its availability gate, with
the JAX package's message, and the host dispatch it leads to."""
import importlib.util

import torch

from metrics_tpu_torch.functional.audio._host import _host_per_sample
from metrics_tpu_torch.utils.checks import _check_same_shape

_PESQ_AVAILABLE = importlib.util.find_spec("pesq") is not None


def perceptual_evaluation_speech_quality(
    preds: torch.Tensor,
    target: torch.Tensor,
    fs: int,
    mode: str,
    keep_same_device: bool = False,
) -> torch.Tensor:
    """PESQ score per sample, shape ``[..., time] -> [...]``, computed on the
    host and returned on the inputs' device.

    Args:
        fs: sampling frequency, 8000 or 16000 Hz.
        mode: ``"wb"`` (wide-band) or ``"nb"`` (narrow-band).

    Raises:
        ModuleNotFoundError: the ``pesq`` wheel is not installed.
    """
    if not _PESQ_AVAILABLE:
        raise ModuleNotFoundError(
            "PESQ metric requires that pesq is installed. Either install as `pip install metrics_tpu[audio]`"
            " or `pip install pesq`."
        )
    import pesq as pesq_backend

    if fs not in (8000, 16000):
        raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
    if mode not in ("wb", "nb"):
        raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
    _check_same_shape(preds, target)
    return _host_per_sample(lambda t, p: pesq_backend.pesq(fs, t, p, mode), preds, target)

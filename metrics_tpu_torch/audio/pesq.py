"""``PerceptualEvaluationSpeechQuality`` (counterpart of ``metrics_tpu/audio/pesq.py``)."""
from typing import Any

import torch

from metrics_tpu_torch.functional.audio import pesq as _pesq
from metrics_tpu_torch.metric import Metric


class PerceptualEvaluationSpeechQuality(Metric):
    """Streaming mean PESQ. The P.862 algorithm runs per sample on the host
    (the optional ``pesq`` wheel); only the accumulation is on the device.
    Without the wheel the constructor raises ``ModuleNotFoundError``."""

    is_differentiable = False
    higher_is_better = True

    def __init__(self, fs: int, mode: str, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not _pesq._PESQ_AVAILABLE:
            raise ModuleNotFoundError(
                "PerceptualEvaluationSpeechQuality metric requires that pesq is installed."
                " Either install as `pip install metrics_tpu[audio]` or `pip install pesq`."
            )
        if fs not in (8000, 16000):
            raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
        self.fs = fs
        if mode not in ("wb", "nb"):
            raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
        self.mode = mode
        self.add_state("sum_pesq", default=0.0, dist_reduce_fx="sum")
        self.add_state("total", default=0, dist_reduce_fx="sum")

    def update(self, preds: torch.Tensor, target: torch.Tensor) -> None:
        pesq_batch = _pesq.perceptual_evaluation_speech_quality(preds, target, self.fs, self.mode)
        self.sum_pesq = self.sum_pesq + pesq_batch.sum()
        self.total = self.total + pesq_batch.numel()

    def compute(self) -> torch.Tensor:
        return self.sum_pesq / self.total

"""PyTorch and CUDA port of ``metrics_tpu``, slice by slice.

This slice runs the streaming classification eval loop: ``Accuracy``,
``F1Score``/``FBetaScore``, ``StatScores``, ``ConfusionMatrix`` and
``MetricCollection``, with their functional forms. Metrics live on the GPU
unless a ``device`` is given; the three kernels of the path
(``confusion_counts``, ``multilabel_counts``, ``select_topk``) are CUDA C++
in ``csrc/``, built with ``nvcc`` at first use.
"""
from metrics_tpu_torch.classification import Accuracy, ConfusionMatrix, F1Score, FBetaScore, StatScores
from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.interop import state_from_jax
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops.registry import kernel_stats, reset_kernel_stats

__all__ = [
    "Accuracy",
    "ConfusionMatrix",
    "F1Score",
    "FBetaScore",
    "Metric",
    "MetricCollection",
    "StatScores",
    "kernel_stats",
    "reset_kernel_stats",
    "state_from_jax",
]

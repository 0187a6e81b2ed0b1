"""PyTorch and CUDA port of ``metrics_tpu``, slice by slice.

Ported so far: the streaming classification eval loop (``Accuracy``,
``F1Score``/``FBetaScore``, ``StatScores``, ``ConfusionMatrix``,
``MetricCollection``) and the curve and calibration metrics (``AUROC``,
``ROC``, ``PrecisionRecallCurve``, ``AveragePrecision``, ``AUC``, the binned
curve family and ``CalibrationError``), with their functional forms. Metrics
live on the GPU unless a ``device`` is given; the five kernels of these paths
(``confusion_counts``, ``multilabel_counts``, ``select_topk``,
``binned_counts``, ``binned_calibration``) are CUDA C++ in ``csrc/``, built
with ``nvcc`` at first use.
"""
from metrics_tpu_torch.classification import (
    AUC,
    AUROC,
    ROC,
    Accuracy,
    AveragePrecision,
    BinnedAveragePrecision,
    BinnedPrecisionRecallCurve,
    BinnedRecallAtFixedPrecision,
    CalibrationError,
    ConfusionMatrix,
    F1Score,
    FBetaScore,
    PrecisionRecallCurve,
    StatScores,
)
from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.interop import state_from_jax
from metrics_tpu_torch.metric import Metric
from metrics_tpu_torch.ops.registry import kernel_stats, reset_kernel_stats

__all__ = [
    "AUC",
    "AUROC",
    "Accuracy",
    "AveragePrecision",
    "BinnedAveragePrecision",
    "BinnedPrecisionRecallCurve",
    "BinnedRecallAtFixedPrecision",
    "CalibrationError",
    "ConfusionMatrix",
    "F1Score",
    "FBetaScore",
    "Metric",
    "MetricCollection",
    "PrecisionRecallCurve",
    "ROC",
    "StatScores",
    "kernel_stats",
    "reset_kernel_stats",
    "state_from_jax",
]

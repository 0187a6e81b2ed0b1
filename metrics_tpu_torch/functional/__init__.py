from metrics_tpu_torch.functional.classification import (
    accuracy,
    auc,
    auroc,
    average_precision,
    calibration_error,
    confusion_matrix,
    f1_score,
    fbeta_score,
    precision_recall_curve,
    roc,
    stat_scores,
)

__all__ = [
    "accuracy",
    "auc",
    "auroc",
    "average_precision",
    "calibration_error",
    "confusion_matrix",
    "f1_score",
    "fbeta_score",
    "precision_recall_curve",
    "roc",
    "stat_scores",
]

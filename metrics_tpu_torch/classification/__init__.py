from metrics_tpu_torch.classification.accuracy import Accuracy
from metrics_tpu_torch.classification.confusion_matrix import ConfusionMatrix
from metrics_tpu_torch.classification.f_beta import F1Score, FBetaScore
from metrics_tpu_torch.classification.stat_scores import StatScores

__all__ = ["Accuracy", "ConfusionMatrix", "F1Score", "FBetaScore", "StatScores"]

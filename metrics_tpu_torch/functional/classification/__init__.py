from metrics_tpu_torch.functional.classification.accuracy import accuracy
from metrics_tpu_torch.functional.classification.confusion_matrix import confusion_matrix
from metrics_tpu_torch.functional.classification.f_beta import f1_score, fbeta_score
from metrics_tpu_torch.functional.classification.stat_scores import stat_scores

__all__ = ["accuracy", "confusion_matrix", "f1_score", "fbeta_score", "stat_scores"]

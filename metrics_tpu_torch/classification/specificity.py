"""Specificity module metric (counterpart of ``metrics_tpu/classification/specificity.py``)."""
import torch

from metrics_tpu_torch.classification.precision_recall import _AveragedStatScores
from metrics_tpu_torch.functional.classification.specificity import _specificity_compute


class Specificity(_AveragedStatScores):
    """Specificity = TN / (TN + FP); arguments as :class:`~metrics_tpu_torch.classification.precision_recall._AveragedStatScores`.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Specificity
        >>> specificity = Specificity(num_classes=3, average="macro", device="cpu")
        >>> print(round(float(specificity(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 2, 2]))), 4))
        0.7222
    """

    def compute(self) -> torch.Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _specificity_compute(tp, fp, tn, fn, self.average, self.mdmc_reduce)

"""Matthews correlation coefficient (counterpart of
``metrics_tpu/functional/classification/matthews_corrcoef.py``).

The update is the confusion matrix's (the ``confusion_counts`` kernel); a
zero denominator gives 0 through ``torch.where``, so the compute captures."""
import torch

from metrics_tpu_torch.functional.classification.confusion_matrix import _confusion_matrix_update

_matthews_corrcoef_update = _confusion_matrix_update


def _matthews_corrcoef_compute(confmat: torch.Tensor) -> torch.Tensor:
    tk = confmat.sum(dim=1).to(torch.float32)
    pk = confmat.sum(dim=0).to(torch.float32)
    c = torch.trace(confmat).to(torch.float32)
    s = confmat.sum().to(torch.float32)

    cov_ytyp = c * s - (tk * pk).sum()
    cov_ypyp = s**2 - (pk * pk).sum()
    cov_ytyt = s**2 - (tk * tk).sum()

    denom = cov_ytyt * cov_ypyp
    zero = denom == 0
    return torch.where(zero, 0.0, cov_ytyp / torch.sqrt(torch.where(zero, 1.0, denom)))


def matthews_corrcoef(preds: torch.Tensor, target: torch.Tensor, num_classes: int, threshold: float = 0.5) -> torch.Tensor:
    """Matthews correlation coefficient of one batch.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import matthews_corrcoef
        >>> print(round(float(matthews_corrcoef(torch.tensor([0, 1, 1, 1]), torch.tensor([0, 1, 0, 1]), num_classes=2)), 4))
        0.5774
    """
    return _matthews_corrcoef_compute(_matthews_corrcoef_update(preds, target, num_classes, threshold))

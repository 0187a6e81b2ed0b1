"""Cohen's kappa (counterpart of ``metrics_tpu/functional/classification/cohen_kappa.py``).

The update is the confusion matrix's (the ``confusion_counts`` kernel)."""
from typing import Optional

import torch

from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _confusion_matrix_compute,
    _confusion_matrix_update,
)

_cohen_kappa_update = _confusion_matrix_update


def _cohen_kappa_compute(confmat: torch.Tensor, weights: Optional[str] = None) -> torch.Tensor:
    """``1 - sum(W * O) / sum(W * E)`` over the observed matrix O and the one
    expected from its marginals E, in float32."""
    confmat = _confusion_matrix_compute(confmat).to(torch.float32)
    n_classes = confmat.shape[0]
    sum0 = confmat.sum(dim=0, keepdim=True)
    sum1 = confmat.sum(dim=1, keepdim=True)
    expected = sum1 @ sum0 / sum0.sum()

    if weights is None:
        w_mat = 1.0 - torch.eye(n_classes, dtype=confmat.dtype, device=confmat.device)
    elif weights in ("linear", "quadratic"):
        idx = torch.arange(n_classes, dtype=confmat.dtype, device=confmat.device)
        diff = idx[None, :] - idx[:, None]
        w_mat = diff.abs() if weights == "linear" else diff**2
    else:
        raise ValueError(f"Received {weights} for argument ``weights`` but should be either None, 'linear' or 'quadratic'")

    k = (w_mat * confmat).sum() / (w_mat * expected).sum()
    return 1 - k


def cohen_kappa(
    preds: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    weights: Optional[str] = None,
    threshold: float = 0.5,
) -> torch.Tensor:
    """Cohen's kappa of one batch; ``weights`` ``None``, ``"linear"`` or
    ``"quadratic"`` (the weighted kappa of ordinal grades).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import cohen_kappa
        >>> print(round(float(cohen_kappa(torch.tensor([0, 1, 2, 2, 1]), torch.tensor([0, 1, 2, 1, 1]), num_classes=3)), 4))
        0.6875
    """
    confmat = _cohen_kappa_update(preds, target, num_classes, threshold)
    return _cohen_kappa_compute(confmat, weights)

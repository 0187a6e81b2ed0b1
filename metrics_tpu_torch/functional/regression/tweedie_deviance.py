"""Tweedie deviance score (counterpart of
``metrics_tpu/functional/regression/tweedie_deviance.py``). The domain checks
read the values (host syncs), so they run on every eager update and skip
inside an engine program, as the JAX ones skip under tracing."""
from typing import Tuple

import torch

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import in_program


def _validate_domain(preds: torch.Tensor, targets: torch.Tensor, power: float) -> None:
    if in_program():
        return
    if power == 1 and (bool((preds <= 0).any()) or bool((targets < 0).any())):
        raise ValueError(f"For power={power}, 'preds' has to be strictly positive and 'targets' cannot be negative.")
    if power == 2 and (bool((preds <= 0).any()) or bool((targets <= 0).any())):
        raise ValueError(f"For power={power}, both 'preds' and 'targets' have to be strictly positive.")
    if power < 0 and bool((preds <= 0).any()):
        raise ValueError(f"For power={power}, 'preds' has to be strictly positive.")
    if 1 < power < 2 and (bool((preds <= 0).any()) or bool((targets < 0).any())):
        raise ValueError(f"For power={power}, 'preds' has to be strictly positive and 'targets' cannot be negative.")
    if power > 2 and (bool((preds <= 0).any()) or bool((targets <= 0).any())):
        raise ValueError(f"For power={power}, both 'preds' and 'targets' have to be strictly positive.")


def _tweedie_deviance_score_update(
    preds: torch.Tensor, targets: torch.Tensor, power: float = 0.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_same_shape(preds, targets)
    if 0 < power < 1:
        raise ValueError(f"Deviance Score is not defined for power={power}.")
    _validate_domain(preds, targets, power)

    if power == 0:
        deviance_score = (targets - preds) ** 2
    elif power == 1:
        positive = targets > 0
        log_term = targets * torch.log(torch.where(positive, targets / preds, torch.ones_like(preds)))
        deviance_score = 2 * (torch.where(positive, log_term, torch.zeros_like(log_term)) + preds - targets)
    elif power == 2:
        deviance_score = 2 * (torch.log(preds / targets) + (targets / preds) - 1)
    else:
        term_1 = torch.pow(targets.clamp(min=0), 2 - power) / ((1 - power) * (2 - power))
        term_2 = targets * torch.pow(preds, 1 - power) / (1 - power)
        term_3 = torch.pow(preds, 2 - power) / (2 - power)
        deviance_score = 2 * (term_1 - term_2 + term_3)

    # a fill, not a host-to-device copy: the update runs inside a CUDA graph capture
    return deviance_score.sum(), torch.full((), targets.numel(), dtype=torch.int64, device=targets.device)


def _tweedie_deviance_score_compute(sum_deviance_score: torch.Tensor, num_observations: torch.Tensor) -> torch.Tensor:
    return sum_deviance_score / num_observations


def tweedie_deviance_score(preds: torch.Tensor, targets: torch.Tensor, power: float = 0.0) -> torch.Tensor:
    """Tweedie deviance: power 0 is MSE, 1 Poisson, 2 Gamma, others compound.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional import tweedie_deviance_score
        >>> preds = torch.tensor([2.0, 0.5, 1.0])
        >>> target = torch.tensor([1.5, 1.0, 1.0])
        >>> print(round(float(tweedie_deviance_score(preds, target, power=0.0)), 4))
        0.1667
    """
    sum_deviance_score, num_observations = _tweedie_deviance_score_update(preds, targets, power)
    return _tweedie_deviance_score_compute(sum_deviance_score, num_observations)

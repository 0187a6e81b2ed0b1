"""Rank-zero gated printing and warnings (counterpart of
``metrics_tpu/utils/prints.py``).

The rank is ``torch.distributed.get_rank()`` once a default process group
is initialised, else 0, so a single process always prints.
"""
import logging
import warnings
from functools import wraps
from typing import Any, Callable

import torch.distributed as dist

log = logging.getLogger("metrics_tpu_torch")


def _rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def rank_zero_only(fn: Callable) -> Callable:
    """Run ``fn`` only on process 0 of a multi-process job."""

    @wraps(fn)
    def wrapped_fn(*args: Any, **kwargs: Any) -> Any:
        if _rank() == 0:
            return fn(*args, **kwargs)
        return None

    return wrapped_fn


@rank_zero_only
def rank_zero_warn(*args: Any, **kwargs: Any) -> None:
    kwargs.setdefault("stacklevel", 3)
    warnings.warn(*args, **kwargs)


@rank_zero_only
def rank_zero_info(*args: Any, **kwargs: Any) -> None:
    log.info(*args, **kwargs)


@rank_zero_only
def rank_zero_debug(*args: Any, **kwargs: Any) -> None:
    log.debug(*args, **kwargs)

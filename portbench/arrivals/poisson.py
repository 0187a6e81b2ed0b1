"""Poisson arrivals at the mix's ``rate_per_s``, made steady from seed to seed.

Every seed gets the same set of exponential gaps (the quantiles of the
exponential distribution, ``-ln(1 - (i + 1/2) / n)`` of the mean gap), in
another order. So every run of a cell offers the same number of requests
with the same gaps, and only their order changes with the seed.

A traffic file names its arrival process under ``arrivals``; each process
is a file of this folder with ``due_times(mix, seconds, rng)``.
"""
from typing import Any, Dict

import numpy as np


def due_times(mix: Dict[str, Any], seconds: float, rng: np.random.Generator) -> np.ndarray:
    """Sorted due times in ``[0, seconds)``."""
    rate = float(mix["rate_per_s"])
    n = int(round(rate * seconds))
    if n == 0:
        return np.zeros(0)
    gaps = rng.permutation(-np.log1p(-(np.arange(n) + 0.5) / n))
    times = np.cumsum(gaps)
    return times * (n / (times[-1] + gaps.mean())) / rate

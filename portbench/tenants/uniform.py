"""Which tenant sends each request: uniform over the tenants.

A traffic file names its draw under ``tenants_draw``; each draw is a file
of this folder with ``draw(mix, n, tenants, rng)``.
"""
from typing import Any, Dict

import numpy as np


def draw(mix: Dict[str, Any], n: int, tenants: int, rng: np.random.Generator) -> np.ndarray:
    return rng.integers(0, tenants, n)

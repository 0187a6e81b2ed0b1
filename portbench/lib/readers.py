"""What the per-layer readers in ``metrics/`` share. Each returns None where
its run gave it nothing to read; a share of a roofline is never made 0."""
from typing import Any, Dict, Optional

import numpy as np

from portbench.lib import roofline


def idle_pct(obs: Dict[str, Any]) -> Optional[float]:
    """100 less the device's busy share of the traced window (the union of its events' intervals)."""
    profile = obs.get("profile")
    if profile is None or profile.window_s <= 0:
        return None
    return 100.0 * (1.0 - profile.busy_s() / profile.window_s)


def flush_host_ms(obs: Dict[str, Any]) -> Optional[float]:
    """Host ms of the router calls that flushed, on the harness's clock, per wave flushed."""
    calls = obs.get("flush_host_ms")
    if not calls:
        return None
    return sum(ms for ms, _ in calls) / sum(waves for _, waves in calls)


def kernel_roofline(obs: Dict[str, Any], op: str, patterns) -> Optional[float]:
    """The least time of the op's calls in the traced window (their bytes at the
    HBM rate) over its kernels' measured device time, in %."""
    profile, n_bytes = obs.get("profile"), obs.get("kernel_bytes", {}).get(op)
    if profile is None or not n_bytes:
        return None
    seconds, count = profile.kernel_time(patterns)
    if count == 0:
        return None
    return roofline.roofline_pct(n_bytes, seconds)


def p95(values) -> Optional[float]:
    return float(np.percentile(np.asarray(values), 95)) if len(values) else None

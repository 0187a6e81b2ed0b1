"""What the program's own ranges, device marks, counts and samples say.

While ``torch.profiler`` records, ``metrics_tpu_torch`` enters a
``record_function`` range ``metrics_tpu_torch.<phase>:<source>`` around each
of its spans (``obs/trace.py``), and the captured programs hold device marks:
one-thread kernels ``metrics_tpu_torch_mark<stage>`` at the formatter's start
(``format``) and return (``update``), at each forward or update program's end
(``end``) and around a bank wave (``wave``, ``wave_end``). The readers here
take them from a :class:`~portbench.lib.profile.DeviceProfile`; the router's
wait samples and the bank's pad counts from ``obs.trace.readings()``. Each
returns None where the run gave it nothing to read: a program without these
ranges, marks or readings.
"""
import bisect
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

RANGE_PREFIX = "metrics_tpu_torch."
FORWARD = RANGE_PREFIX + "forward:MetricCollection"
BANK_DISPATCH = RANGE_PREFIX + "bank.dispatch:"
_MARK = re.compile(r"metrics_tpu_torch_mark<(?:\w+::)*(\w+)>")
#: CUDA runtime calls that make the host wait for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")

Interval = Tuple[float, float]


def from_profile(obs: Dict, fn, *args) -> Optional[float]:
    """``fn(profile, *args)`` of the run's traced window; None without one."""
    profile = obs.get("profile")
    return None if profile is None else fn(profile, *args)


def marks(profile) -> List[Tuple[float, float, str]]:
    """The device marks of the window, ``(start_us, end_us, stage)`` in time order."""
    out = []
    for start, stop, name in profile.device:
        m = _MARK.search(name)
        if m:
            out.append((start, stop, m.group(1)))
    return out


def _in_window(profile, start: float) -> bool:
    return profile.window[0] <= start <= profile.window[1]


def host_ranges(profile, prefix: str = RANGE_PREFIX) -> List[Tuple[float, float, str]]:
    """The program's host ranges whose name starts with ``prefix`` and which start in the window."""
    return [h for h in profile.host if h[2].startswith(prefix) and _in_window(profile, h[0])]


def forwards(profile) -> int:
    """``MetricCollection.forward`` calls that started in the window."""
    return sum(1 for h in host_ranges(profile, FORWARD) if h[2] == FORWARD)


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """Sorted, disjoint intervals covering the same time."""
    out: List[List[float]] = []
    for start, stop in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], stop)
        else:
            out.append([start, stop])
    return [(a, b) for a, b in out]


def overlap(merged: List[Interval], lo: float, hi: float) -> float:
    """Time of ``[lo, hi]`` that the disjoint sorted intervals ``merged`` cover."""
    i = max(0, bisect.bisect_right(merged, (lo, float("inf"))) - 1)
    total = 0.0
    while i < len(merged) and merged[i][0] < hi:
        total += max(0.0, min(hi, merged[i][1]) - max(lo, merged[i][0]))
        i += 1
    return total


def covers(merged: List[Interval], t: float) -> bool:
    """Whether ``t`` lies in one of the disjoint sorted intervals ``merged``."""
    i = bisect.bisect_right(merged, (t, float("inf"))) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


def stage_device_ms(profile, stage: str) -> Optional[float]:
    """Device busy time (the union of the device events) from each ``stage``
    mark to the next mark, summed, in ms per collection ``forward``."""
    ms, n = marks(profile), forwards(profile)
    if not ms or n == 0:
        return None
    busy = union([(s, e) for s, e, _ in profile.device])
    total = sum(overlap(busy, ms[i][1], ms[i + 1][0]) for i in range(len(ms) - 1) if ms[i][2] == stage)
    return total / 1e3 / n


def host_syncs_per_forward(profile) -> Optional[float]:
    """Synchronizing CUDA runtime calls inside the program's ranges, per collection ``forward``."""
    n = forwards(profile)
    if n == 0:
        return None
    inside = union([(s, e) for s, e, _ in host_ranges(profile)])
    syncs = sum(1 for s, _, name in profile.host if name in SYNC_CALLS and _in_window(profile, s) and covers(inside, s))
    return syncs / n


def idle_in_program_pct(profile) -> Optional[float]:
    """% of the window in which the device is idle while the host is inside one of the program's ranges."""
    ranges = host_ranges(profile)
    if not ranges or profile.window_s <= 0:
        return None
    lo, hi = profile.window
    inside = union([(max(s, lo), min(e, hi)) for s, e, _ in ranges])
    idle = sum(overlap(inside, s, e) for s, e in profile.gaps())
    return 100.0 * idle / (hi - lo)


def wave_device_ms(profile) -> Optional[float]:
    """Mean device ms from a ``wave`` mark to the ``wave_end`` mark after it."""
    times, start = [], None
    for s, e, stage in marks(profile):
        if stage == "wave":
            start = e
        elif stage == "wave_end" and start is not None:
            times.append(s - start)
            start = None
    return float(np.mean(times)) / 1e3 if times else None


def launch_wait_ms(profile) -> Optional[float]:
    """Mean ms from the end of a wave's host ``bank.dispatch`` range to its
    ``wave`` mark on the device (0 where the wave started before the range
    ended): the wave's wait behind earlier device work."""
    waves = [s for s, _, stage in marks(profile) if stage == "wave"]
    waits, j = [], 0
    for start, stop, _ in sorted(host_ranges(profile, BANK_DISPATCH)):
        while j < len(waves) and waves[j] < start:
            j += 1
        if j == len(waves):
            break
        waits.append(max(0.0, waves[j] - stop))
        j += 1
    return float(np.mean(waits)) / 1e3 if waits else None


def readings(obs: Dict) -> Dict[str, Dict]:
    """``obs.trace.readings()`` of the program in this process, after a
    traced window (the program keeps them only while traced); empty where
    there was none or the program keeps none."""
    if obs.get("profile") is None:
        return {}
    from metrics_tpu_torch.obs import trace

    read = getattr(trace, "readings", None)
    return read() if read is not None else {}


def sample_p95(obs: Dict, name: str) -> Optional[float]:
    """95th percentile of the program's samples ``name``."""
    values = readings(obs).get("samples", {}).get(name)
    return float(np.percentile(np.asarray(values), 95)) if values else None


def pad_pct(obs: Dict) -> Optional[float]:
    """The bank's pow2 pad requests over the requests its waves launched, in %."""
    counts = readings(obs).get("counts", {})
    launched = counts.get("bank.rows_launched", 0)
    return 100.0 * counts.get("bank.rows_padded", 0) / launched if launched else None

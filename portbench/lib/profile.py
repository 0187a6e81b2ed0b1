"""What a ``torch.profiler`` trace of the traced window says about the device.

The busy time is the union of the device events' intervals, a frozen copy
of ``chip_smoke.py``'s ``_device_busy``: summed kernel time would exceed it
where events overlap. Unlike that copy, it leaves out the
``record_function`` ranges that the trace repeats on the device's timeline:
they ran no work. Idle gaps are the stretches of the window in which no
device event ran, each named by what the host was doing then: the
harness's own label (``portbench.*``, a ``record_function`` around each call
into the program) and the innermost host operation under it.
"""
import bisect
import collections
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

HARNESS_PREFIX = "portbench."
BREAKDOWN_ROWS = 10


def _is_device(evt) -> bool:
    return "CUDA" in str(getattr(evt, "device_type", ""))


def _is_annotation(evt) -> bool:
    """A ``record_function`` range; the trace repeats each on the device's timeline, where it ran no work."""
    return bool(getattr(evt, "is_user_annotation", False)) or evt.name.startswith(HARNESS_PREFIX)


class DeviceProfile:
    """The device and host events of one traced window.

    ``window`` is ``(start_us, end_us)`` on the profiler's clock; the window
    starts and ends with the harness's own label ``portbench.window``.
    """

    def __init__(self, events: Iterable, window_label: str = HARNESS_PREFIX + "window") -> None:
        device, host = [], []
        window: Optional[Tuple[float, float]] = None
        for evt in events:
            start, end = evt.time_range.start, evt.time_range.end
            if _is_device(evt):
                if end > start and not _is_annotation(evt):
                    device.append((start, end, evt.name))
            elif evt.name == window_label:
                window = (start, end)
            else:
                host.append((start, end, evt.name))
        if window is None:
            raise ValueError(f"the trace holds no {window_label!r} range")
        lo, hi = window
        self.window = window
        self.device = sorted((max(s, lo), min(e, hi), n) for s, e, n in device if e > lo and s < hi)
        self.host = sorted(host)
        self._host_starts = [h[0] for h in self.host]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def ops(self) -> int:
        """Device operations (kernels, copies, fills) that ran in the window."""
        return len(self.device)

    def busy_s(self) -> float:
        """The union of the device events' intervals (``_device_busy``)."""
        busy, end = 0.0, float("-inf")
        for start, stop, _ in self.device:
            busy += max(0.0, stop - max(start, end))
            end = max(end, stop)
        return busy / 1e6

    def kernel_time(self, patterns: Sequence[str]) -> Tuple[float, int]:
        """Seconds and count of the device events whose name holds any of ``patterns``."""
        total, count = 0.0, 0
        for start, stop, name in self.device:
            if any(p in name for p in patterns):
                total += stop - start
                count += 1
        return total / 1e6, count

    def top_ops(self, rows: int = BREAKDOWN_ROWS) -> List[List]:
        by_name: Dict[str, float] = collections.defaultdict(float)
        for start, stop, name in self.device:
            by_name[name] += stop - start
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:rows]
        return [[name[:160], us / 1e6] for name, us in top]

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle stretches of the window, ``(start_us, end_us)``."""
        out, cursor = [], self.window[0]
        for start, stop, _ in self.device:
            if start > cursor:
                out.append((cursor, start))
            cursor = max(cursor, stop)
        if self.window[1] > cursor:
            out.append((cursor, self.window[1]))
        return out

    def _host_at(self, t: float) -> str:
        """The harness label covering ``t``, and the innermost host operation under it."""
        i = bisect.bisect_right(self._host_starts, t)
        label, inner, inner_start = None, None, float("-inf")
        # host ranges nest; a harness call is short, so look back a bounded way
        for start, stop, name in reversed(self.host[max(0, i - 4096):i]):
            if stop < t:
                continue
            if name.startswith(HARNESS_PREFIX):
                if label is None:
                    label = name[len(HARNESS_PREFIX):]
            elif start > inner_start:
                inner, inner_start = name, start
        label = label or "outside the harness's calls"
        return label if inner is None else f"{label} / {inner[:80]}"

    def idle_gaps(self, rows: int = BREAKDOWN_ROWS) -> List[List]:
        by_what: Dict[str, float] = collections.defaultdict(float)
        for start, stop in self.gaps():
            by_what[self._host_at((start + stop) / 2)] += stop - start
        top = sorted(by_what.items(), key=lambda kv: -kv[1])[:rows]
        return [[what, us / 1e6] for what, us in top]

    def breakdown(self) -> Dict[str, List[List]]:
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}


def label(torch, active: bool, name: str):
    """A ``portbench.<name>`` range around a call into the program while traced; nothing otherwise."""
    from contextlib import nullcontext

    return torch.profiler.record_function(HARNESS_PREFIX + name) if active else nullcontext()


def warm_profiler(torch, device) -> None:
    """Start and stop the profiler once on a tiny op, so that the traced
    window's start does not pay CUPTI's initialisation."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)


def profiler(torch):
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

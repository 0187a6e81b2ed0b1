"""The readers of the program's own ranges, marks, counts and samples
(``lib/program_spans.py``) on synthetic traces: ``python -m pytest portbench``."""
from types import SimpleNamespace

import pytest

from portbench.lib import program_spans, spec
from portbench.lib.profile import DeviceProfile


def _evt(start, end, name, device=False):
    kind = "DeviceType.CUDA" if device else "DeviceType.CPU"
    return SimpleNamespace(time_range=SimpleNamespace(start=start, end=end), name=name, device_type=kind)


def _mark(at, stage):
    return _evt(at, at + 1, f"void metrics_tpu_torch_mark<mt_stage::{stage}>()", device=True)


FWD = "metrics_tpu_torch.forward:MetricCollection"


def _two_forwards():
    """Two forwards of one member each: format 10 us busy of 20, update 5, then the end mark."""
    events = [_evt(0, 1000, "portbench.window")]
    for base in (0, 500):
        events += [
            _evt(base + 10, base + 200, FWD),
            _evt(base + 20, base + 60, "metrics_tpu_torch.engine.replay:fused_forward"),
            _evt(base + 30, base + 40, "cudaGraphLaunch"),
            _evt(base + 0, base + 20, "Memcpy DtoD", device=True),  # the copy-in, before the program's marks
            _mark(base + 50, "format"),
            _evt(base + 51, base + 56, "reduce_kernel", device=True),
            _evt(base + 54, base + 61, "elementwise_kernel", device=True),  # overlaps: union 51-61
            _mark(base + 71, "update"),
            _evt(base + 72, base + 77, "confusion_shared_kernel", device=True),
            _mark(base + 80, "end"),
        ]
    events.append(_evt(150, 160, "cudaStreamSynchronize"))  # inside the first forward's range
    events.append(_evt(900, 910, "cudaStreamSynchronize"))  # outside every program range
    events.append(_evt(300, 320, "cudaMemcpyAsync"))  # not a sync
    return DeviceProfile(events)


def test_stage_device_ms_is_busy_time_between_marks_per_forward():
    prof = _two_forwards()
    assert program_spans.forwards(prof) == 2
    assert [m[2] for m in program_spans.marks(prof)] == ["format", "update", "end"] * 2
    assert program_spans.stage_device_ms(prof, "format") == pytest.approx(10 / 1e3)
    assert program_spans.stage_device_ms(prof, "update") == pytest.approx(5 / 1e3)
    assert program_spans.stage_device_ms(prof, "wave") == 0.0


def test_host_syncs_count_only_inside_program_ranges():
    assert program_spans.host_syncs_per_forward(_two_forwards()) == pytest.approx(0.5)


def test_idle_in_program_is_idle_time_under_the_program_ranges():
    prof = _two_forwards()
    gaps = prof.gaps()
    inside = program_spans.union([(s, e) for s, e, _ in program_spans.host_ranges(prof)])
    want = sum(program_spans.overlap(inside, s, e) for s, e in gaps)
    # each forward's range (10-200) is idle 20-50, 61-71, 77-80 and 81-200: 30 + 10 + 3 + 119
    assert want == pytest.approx(2 * 162)
    assert program_spans.idle_in_program_pct(prof) == pytest.approx(100 * 2 * 162 / 1000)


def test_wave_device_ms_and_launch_wait():
    events = [
        _evt(0, 10_000, "portbench.window"),
        _evt(100, 400, "metrics_tpu_torch.bank.dispatch:MetricBank"),
        _mark(450, "wave"),  # 50 us behind the range's end
        _evt(451, 2451, "kernel", device=True),
        _mark(2451, "wave_end"),
        _evt(2500, 2600, "metrics_tpu_torch.bank.dispatch:MetricBank"),
        _mark(2550, "wave"),  # began before the range ended: no wait
        _evt(2551, 3551, "kernel", device=True),
        _mark(3551, "wave_end"),
    ]
    prof = DeviceProfile(events)
    assert program_spans.wave_device_ms(prof) == pytest.approx((2000 + 1000) / 2 / 1e3)
    assert program_spans.launch_wait_ms(prof) == pytest.approx(50 / 2 / 1e3)


def test_readers_find_nothing_in_a_program_without_ranges_or_marks():
    prof = DeviceProfile([_evt(0, 100, "portbench.window"), _evt(10, 20, "kernel", device=True)])
    for fn in (
        program_spans.host_syncs_per_forward, program_spans.idle_in_program_pct,
        program_spans.wave_device_ms, program_spans.launch_wait_ms,
    ):
        assert fn(prof) is None
    assert program_spans.stage_device_ms(prof, "format") is None
    assert program_spans.from_profile({}, program_spans.wave_device_ms) is None


def test_counts_and_samples_are_read_after_a_traced_window(monkeypatch):
    from metrics_tpu_torch.obs import trace

    trace.clear()
    try:
        trace.count("bank.rows_launched", 8)
        trace.count("bank.rows_padded", 2)
        for v in range(1, 101):
            trace.sample("router.queue_wait_ms", float(v))
        traced = {"profile": DeviceProfile([_evt(0, 1, "portbench.window")])}
        assert program_spans.pad_pct(traced) == pytest.approx(25.0)
        assert program_spans.sample_p95(traced, "router.queue_wait_ms") == pytest.approx(95.05)
        assert spec.read_metric("bank.pad_pct.open", traced) == pytest.approx(25.0)
        assert program_spans.pad_pct({}) is None  # no traced window: nothing read
        monkeypatch.delattr(trace, "readings")  # a program that keeps none
        assert program_spans.pad_pct(traced) is None
        assert program_spans.sample_p95(traced, "router.queue_wait_ms") is None
    finally:
        trace.clear()

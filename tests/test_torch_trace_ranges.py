"""The port's own spans on the profiler's clock, its device marks, and the
counts and samples ``obs.trace`` keeps where work waits (``obs/trace.py``),
on the CPU:

* with tracing, the bus and the profiler off, a collection ``forward`` and a
  bank wave build no span and enter no profiler range;
* under ``torch.profiler``, the host events hold the lifecycle, engine, bank
  and router ranges, named ``metrics_tpu_torch.<phase>:<source>``;
* the marks fire in order and number (``format`` and ``update`` per member,
  one ``end`` a program, ``wave`` and ``wave_end`` alone for a bank wave),
  with the launcher replaced by a recorder;
* the router's wait samples and the bank's pad counts on a hand-built
  sequence of submits, and the reservoir's bound.
"""
import pytest
import torch

import metrics_tpu_torch as mt
from metrics_tpu_torch import engine, obs
from metrics_tpu_torch.obs import trace
from metrics_tpu_torch.serving import MetricBank, RequestRouter

C = 5
ROWS = 4


@pytest.fixture(autouse=True)
def _quiet_obs():
    def quiet():
        obs.disable()
        obs.disable_tracing()
        obs.bus.clear()
        trace.clear()

    quiet()
    engine.clear_cache()
    yield
    quiet()


def _collection():
    return mt.MetricCollection({
        "top1": mt.Accuracy(num_classes=C, device="cpu"),
        "top2": mt.Accuracy(num_classes=C, top_k=2, device="cpu"),
        "f1": mt.F1Score(num_classes=C, average="macro", device="cpu"),
        "cm": mt.ConfusionMatrix(num_classes=C, device="cpu"),
    })


def _batch(seed, n=ROWS):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, C, generator=g), torch.randint(0, C, (n,), generator=g)


def _bank(tenants):
    return MetricBank(_collection(), capacity=tenants, name="trace-ranges")


@pytest.fixture
def recorded_marks(monkeypatch):
    seen = []
    monkeypatch.setattr(trace, "_launch_mark", lambda stage, like: seen.append(trace.MARK_STAGES[stage]))
    return seen


def test_disabled_path_builds_no_span_and_enters_no_range(monkeypatch):
    built, entered = [], []
    real_span = trace.span

    class CountingSpan(real_span):
        __slots__ = ()

        def __init__(self, *args, **kwargs):
            built.append(args[0])
            super().__init__(*args, **kwargs)

    real_range = trace._Range

    def counting_range(name):
        entered.append(name)
        return real_range(name)

    monkeypatch.setattr(trace, "span", CountingSpan)
    monkeypatch.setattr(trace, "_Range", counting_range)
    mc = _collection()
    bank = _bank(8)
    router = RequestRouter(bank, max_requests=8, max_delay_s=None)

    def run():
        for i in range(3):
            mc(*_batch(i))
        for t in range(6):
            router.submit(t, *_batch(10 + t))
        router.flush()

    assert not trace.active()
    run()
    assert built == [] and entered == []
    assert trace.readings() == {"counts": {}, "samples": {}}
    # tracing on, the profiler off: spans, and still no range
    obs.enable_tracing()
    run()
    assert {"forward", "engine.key", "router.flush", "bank.prepare", "bank.dispatch", "bank.write_back"} <= set(built)
    assert entered == []


def test_profiler_sees_the_program_ranges():
    mc = _collection()
    bank = _bank(8)
    router = RequestRouter(bank, max_requests=8, max_delay_s=None)
    mc(*_batch(0))  # the program's first run outside the trace
    with torch.profiler.profile() as prof:
        assert trace.active()
        mc(*_batch(1))
        mc.compute()
        for t in range(5):
            router.submit(t, *_batch(10 + t))
        router.flush()
    assert not trace.active()
    names = {e.name for e in prof.events()}
    for want in (
        "metrics_tpu_torch.forward:MetricCollection",
        "metrics_tpu_torch.compute:MetricCollection",
        "metrics_tpu_torch.engine.key:fused_forward",
        "metrics_tpu_torch.engine.key:collection_bank",
        "metrics_tpu_torch.router.flush:RequestRouter",
        "metrics_tpu_torch.bank.prepare:MetricBank",
        "metrics_tpu_torch.bank.dispatch:MetricBank",
        "metrics_tpu_torch.bank.write_back:MetricBank",
    ):
        assert want in names, want
    # the ranges are entered directly, without record_function's own operations
    assert not {"profiler::_record_function_enter_new", "profiler::_record_function_exit"} & names
    # the profiler alone aggregates nothing and streams nothing
    assert trace.span_summary() == {} and obs.events() == []


def test_new_phases_feed_the_aggregate_and_emit_no_event():
    obs.enable()
    obs.enable_tracing()
    with trace.span("engine.replay", "fused_forward"):
        pass
    with trace.span("update", "Demo"):
        pass
    assert [e.kind for e in obs.events()] == ["update"]
    summary = trace.span_summary()
    assert summary["engine.replay"]["fused_forward"]["count"] == 1
    assert "engine.replay" not in obs.EVENT_KINDS


def test_marks_in_order_and_number(recorded_marks):
    mc = _collection()
    for i in range(2):
        recorded_marks.clear()
        mc(*_batch(i))
        assert recorded_marks == ["format", "update"] * 4 + ["end"]
    recorded_marks.clear()
    mc.update(*_batch(2))
    assert recorded_marks == ["format", "update"] * 4 + ["end"]
    recorded_marks.clear()
    mc.compute()
    acc = mt.Accuracy(num_classes=C, device="cpu")
    acc.update(*_batch(3))
    assert recorded_marks == ["format", "update", "end"]
    recorded_marks.clear()
    # outside a program the formatter marks nothing
    mt.functional.accuracy(*_batch(4), num_classes=C)
    assert recorded_marks == []


def test_a_bank_wave_marks_its_start_and_end_alone(recorded_marks):
    bank = _bank(64)
    for wave in range(2):
        recorded_marks.clear()
        assert bank.apply_batch([(t, _batch(100 * wave + t)) for t in range(64)]) == 64
        assert recorded_marks == ["wave", "wave_end"]
    # a single metric's bank: its waves mark alike, its epochs' steps not at all
    solo = MetricBank(mt.Accuracy(num_classes=C, device="cpu"), capacity=4, name="trace-ranges-solo")
    recorded_marks.clear()
    solo.apply_batch([(t, _batch(t)) for t in range(3)])
    assert recorded_marks == ["wave", "wave_end"]
    recorded_marks.clear()
    assert solo.drive(0, [_batch(7), _batch(8)]) == 2
    assert recorded_marks == []


def test_router_wait_samples_and_pad_counts():
    now = [0.0]
    bank = _bank(8)
    router = RequestRouter(bank, max_requests=4, max_delay_s=0.05, clock=lambda: now[0])
    obs.enable_tracing()

    def submit_at(t, tenant):
        now[0] = t
        return router.submit(tenant, *_batch(tenant))

    for t, tenant in ((0.0, 0), (0.01, 1), (0.02, 2)):
        assert submit_at(t, tenant) == 0
    now[0] = 0.06
    assert router.poll() == 3  # the deadline: waits of 60, 50 and 40 ms, a wave of 3 padded to 4
    for tenant in range(4):
        submit_at(0.1, tenant)  # the fourth fills the wave: 4 waits of 0
    submit_at(0.2, 5)
    now[0] = 0.25
    assert router.flush() == 1  # a flush the caller asked for, read on the clock: 50 ms
    got = trace.readings()
    assert sorted(got["samples"]["router.queue_wait_ms"]) == pytest.approx([0, 0, 0, 0, 40, 50, 50, 60])
    assert got["counts"] == {"bank.rows_launched": 4 + 4 + 1, "bank.rows_padded": 1}
    trace.clear()
    assert trace.readings() == {"counts": {}, "samples": {}}


def test_untraced_submits_leave_no_sample():
    now = [0.0]
    router = RequestRouter(_bank(4), max_requests=4, max_delay_s=0.05, clock=lambda: now[0])
    router.submit(0, *_batch(0))
    obs.enable_tracing()  # submitted before tracing: no submit time to measure from
    now[0] = 0.1
    router.poll()
    assert "router.queue_wait_ms" not in trace.readings()["samples"]


def test_reservoir_is_bounded_and_uniform_draws_replace(monkeypatch):
    monkeypatch.setattr(trace, "SAMPLE_CAPACITY", 8)
    for v in range(100):
        trace.sample("x", float(v))
    kept = trace.readings()["samples"]["x"]
    assert len(kept) == 8 and len(set(kept)) == 8 and set(kept) <= set(map(float, range(100)))
    assert kept != [float(v) for v in range(8)]  # later samples took places

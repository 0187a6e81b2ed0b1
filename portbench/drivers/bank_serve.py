"""Per-tenant requests through ``RequestRouter`` into a ``MetricBank``.

Traffic parameters (``traffic/<name>.json``, ``"kind": "bank_serve"``):

* ``tenants``, ``capacity``: sessions, and the bank's slots (all resident
  when they are equal: no store read, no spill);
* ``request_rows``: rows of one request; ``pool_blocks``: seeded blocks of
  that many rows held on the device, from which each request takes one;
* ``max_requests``, ``max_delay_s``: the router's size and deadline flushes;
* ``rate_per_s``: the open loop's offered load; ``arrivals`` and
  ``tenants_draw`` name the files of ``arrivals/`` and ``tenants/`` that
  make the due times and pick each request's tenant;
* ``warmup_wave_sizes``, ``warmup_waves_per_size``: waves run in set-up, so
  every wave shape of the traffic is captured and every tenant admitted;
* ``traced_seconds``: more of the same load under the profiler after the
  window (``--trace 1``);
* ``prelude_s``: seconds of the same load that end the set-up, so the
  window starts in the steady state;
* ``settle_s``: how long after the window the last requests are waited for.

A wave's completion is read without a host sync: an event recorded on the
stream the wave ran on, after ``apply_batch`` returned, and timed against
one recorded at the window's start. Every request of a run is applied to
its tenant's row; once the window has closed, ``compute_many`` reads every
tenant, and each is held against the reference over the blocks that tenant
was sent.
"""
import collections
import gc
import math
import time

import numpy as np

from portbench.lib import harness
from portbench.lib import spec as _spec
from portbench.lib.compare import Gaps
from portbench.lib.profile import DeviceProfile, label, profiler, warm_profiler

#: each tenant's blocks repeat after this many of its requests
BLOCK_TABLE = 4096


class _Stamps:
    """When each wave completed, in seconds since the window's anchor."""

    def __init__(self, torch, cuda: bool) -> None:
        self.torch, self.cuda = torch, cuda
        self.t0 = 0.0
        self.ev0 = None

    def anchor(self) -> float:
        """Call with the device idle: the host clock and the device's agree from here."""
        if self.cuda:
            self.torch.cuda.synchronize()
            self.ev0 = self.torch.cuda.Event(enable_timing=True)
            self.ev0.record()
            self.ev0.synchronize()
        self.t0 = time.perf_counter()
        return self.t0

    def stamp(self):
        if not self.cuda:
            return time.perf_counter() - self.t0
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def done(self, st) -> bool:
        return True if not self.cuda else st.query()

    def seconds(self, st) -> float:
        return st if not self.cuda else self.ev0.elapsed_time(st) / 1e3


class _Observed:
    """The bank as its router sees it, each applied wave handed to ``on_wave``."""

    def __init__(self, bank, on_wave) -> None:
        self._bank = bank
        self._on_wave = on_wave

    def __getattr__(self, name):
        return getattr(self._bank, name)

    def apply_batch(self, requests, request_ids=None):
        if request_ids is None:
            applied = self._bank.apply_batch(requests)
        else:
            applied = self._bank.apply_batch(requests, request_ids=request_ids)
        self._on_wave([t for t, _ in requests], applied)
        return applied


class _Book:
    """Every request of the run: its tenant, block, due time and wave."""

    def __init__(self, tenants: int) -> None:
        self.tenant, self.block, self.due, self.wave = [], [], [], []
        self.count = [0] * tenants  # requests each tenant has sent
        self.queued = [collections.deque() for _ in range(tenants)]  # request ids sent, not yet applied
        self.applied = [[] for _ in range(tenants)]  # blocks applied, in order
        self.waves = []  # [stamp, request ids]
        self.in_flight = collections.deque()  # wave ids not yet seen complete
        self.done_at = {}  # wave id -> seconds since the anchor
        self.refused = 0

    def add(self, tenant: int, block: int, due: float) -> int:
        rid = len(self.tenant)
        self.tenant.append(tenant)
        self.block.append(block)
        self.due.append(due)
        self.wave.append(-1)
        self.count[tenant] += 1
        self.queued[tenant].append(rid)
        return rid


def run(run, mt, torch):
    from metrics_tpu_torch import engine
    from metrics_tpu_torch.serving import MetricBank, RequestRouter

    cfg, mix, device = run.cfg, run.traffic, run.device
    tenants, rows, c = mix["tenants"], mix["request_rows"], cfg["classes"]
    maker = _spec.plugin("makers", cfg["inputs"]["maker"])
    logits, target = maker.make(cfg["inputs"], mix["pool_blocks"] * rows, run.generator(torch), device)
    logits = logits.view(mix["pool_blocks"], rows, -1)
    target = target.view(mix["pool_blocks"], rows)
    table = run.rng(2).integers(0, mix["pool_blocks"], (tenants, BLOCK_TABLE))
    run.sync(torch)
    run.part("inputs")

    run.reset_peak(torch)
    bank = MetricBank(harness.build_collection(mt, cfg, device), capacity=mix["capacity"], name=run.workload["name"])
    book = _Book(tenants)
    stamps = _Stamps(torch, run.on_cuda())
    state = {"tracing": False}

    def on_wave(ts, applied):
        wid = len(book.waves)
        ids = [book.queued[t].popleft() for t in ts]
        if applied != len(ts):
            book.refused += len(ts) - applied
        for rid in ids:
            book.wave[rid] = wid
            book.applied[book.tenant[rid]].append(book.block[rid])
        book.waves.append([stamps.stamp(), ids])
        book.in_flight.append(wid)

    router = RequestRouter(_Observed(bank, on_wave), max_requests=mix["max_requests"], max_delay_s=mix["max_delay_s"])
    submit = router.submit if run.fault is None else run.fault(router)
    run.part("build")

    def next_block(t: int) -> int:
        return int(table[t, book.count[t] % BLOCK_TABLE])

    def submit_one(t: int) -> int:
        """Send tenant ``t``'s newest request."""
        block = book.block[book.queued[t][-1]]
        return submit(t, logits[block], target[block])

    submit_one.__name__ = "submit"

    # set-up: every wave shape the traffic makes, every tenant admitted
    cursor, largest = 0, max(mix["warmup_wave_sizes"])
    warm_waves = [size for size in mix["warmup_wave_sizes"] for _ in range(mix["warmup_waves_per_size"])]
    warm_waves += [largest] * max(0, math.ceil((tenants - sum(warm_waves)) / largest))
    for size in warm_waves:
        for _ in range(size):
            t = cursor % tenants
            book.add(t, next_block(t), math.nan)
            submit_one(t)
            cursor += 1
        router.flush()
    book.in_flight.clear()
    run.sync(torch)
    run.part("warmup")

    flush_ms, late = [], []  # (ms, waves) of each call that flushed; ms each request was sent late

    def timed(fn, *args):
        """One call into the router; its host time when it flushed a wave."""
        waves0 = len(book.waves)
        t = time.perf_counter()
        with label(torch, state["tracing"], fn.__name__):
            flushed = fn(*args)
        if len(book.waves) > waves0 and not state["tracing"]:
            flush_ms.append(((time.perf_counter() - t) * 1e3, len(book.waves) - waves0))
        return flushed

    def retire():
        """Note the waves seen complete, oldest first."""
        while book.in_flight and stamps.done(book.waves[book.in_flight[0]][0]):
            wid = book.in_flight.popleft()
            book.done_at[wid] = stamps.seconds(book.waves[wid][0])

    def open_loop(dues, who, blocks, offset: float):
        """Send each request when due (``offset`` shifts the schedule), until it is spent."""
        i, n = 0, len(dues)
        while i < n:
            now = time.perf_counter() - stamps.t0
            while i < n and dues[i] + offset <= now:
                t = int(who[i])
                book.add(t, int(blocks[i]), dues[i] + offset)
                if not state["tracing"]:
                    late.append((now - dues[i] - offset) * 1e3)
                timed(submit_one, t)
                i += 1
                now = time.perf_counter() - stamps.t0
            timed(router.poll)
            retire()
            if i < n:
                wait = dues[i] + offset - (time.perf_counter() - stamps.t0)
                if wait > 5e-4:
                    with label(torch, state["tracing"], "wait_for_arrival"):
                        time.sleep(min(wait - 2e-4, 1e-3))

    def drain():
        """No more requests: the router's deadline flushes the rest; then wait for the device."""
        limit = time.perf_counter() + mix["settle_s"]
        with label(torch, state["tracing"], "drain"):
            while router.pending and time.perf_counter() < limit:
                timed(router.poll)
                retire()
                time.sleep(1e-4)
            run.sync(torch)
        retire()

    def schedule(seconds: float, stream: int):
        """The open loop's due times, tenants and blocks for ``seconds``, from rng stream ``stream``."""
        rng = run.rng(stream)
        dues = _spec.plugin("arrivals", mix["arrivals"]).due_times(mix, seconds, rng)
        who = _spec.plugin("tenants", mix["tenants_draw"]).draw(mix, len(dues), tenants, rng)
        return dues, who, rng.integers(0, mix["pool_blocks"], len(dues))

    # set-up ends with the same load for prelude_s, so the window starts in its steady state
    stamps.anchor()
    open_loop(*schedule(mix["prelude_s"], 5), 0.0)
    drain()
    del flush_ms[:], late[:]
    compiles0 = engine.cache_summary()["compiles"]
    if run.trace and run.on_cuda():
        warm_profiler(torch, device)
    run.part("prelude")
    harness.settle_heap()
    run.setup_done()

    # the window
    stamps.anchor()
    first = len(book.tenant)
    open_loop(*schedule(run.seconds, 3), 0.0)
    last = len(book.tenant)
    backlog = router.pending + sum(len(book.waves[w][1]) for w in book.in_flight)
    drain()
    peak = run.peak_bytes(torch)

    obs = {"flush_host_ms": flush_ms, "late_ms": late, "backlog_at_close": backlog, "captures": engine.cache_summary()["compiles"] - compiles0}
    profile = None
    if run.trace and run.on_cuda():
        with profiler(torch) as prof:
            state["tracing"] = True
            due = schedule(mix["traced_seconds"], 4)
            offset = time.perf_counter() - stamps.t0
            with torch.profiler.record_function("portbench.window"):
                open_loop(*due, offset)
            drain()
            state["tracing"] = False
        profile = DeviceProfile(prof.events())
        obs["profile"] = profile

    # the timed path's outputs, then the program goes before the reference runs
    got_values = bank.compute_many(range(tenants))
    del bank, router, submit
    gc.collect()
    if run.on_cuda():
        torch.cuda.empty_cache()

    window_ids = range(first, last)
    end = run.seconds
    done = [rid for rid in window_ids if book.wave[rid] >= 0 and book.wave[rid] in book.done_at]
    completed_in_window = sum(1 for rid in done if book.done_at[book.wave[rid]] <= end)
    latency = []
    for rid in window_ids:
        w = book.wave[rid]
        latency.append((book.done_at[w] - book.due[rid]) * 1e3 if w >= 0 and w in book.done_at else math.inf)
    failed = sum(1 for x in latency if math.isinf(x)) + book.refused
    thirds = np.array_split(np.array(latency), 3) if latency else []
    obs["latency_by_third_ms"] = [float(np.mean(x)) if len(x) else math.nan for x in thirds]
    sizes = [len(w[1]) for w in book.waves if w[1] and book.wave[w[1][0]] >= 0 and first <= w[1][0] < last]
    obs["mean_wave"] = float(np.mean(sizes)) if sizes else math.nan
    done_times = np.array([book.done_at[book.wave[rid]] for rid in done])
    obs["completed_by_quarter"] = np.bincount(np.clip((done_times / end * 4).astype(int), 0, 4), minlength=5)[:4].tolist()
    e2e = {
        "bank_requests_per_s": completed_in_window / run.seconds,
        "bank_request_p95_ms": float(np.percentile(np.array(latency), 95)) if latency else math.inf,
        "device_peak_gib": peak / 2**30,
    }
    run.log(
        f"window: {last - first} requests sent, {len(done)} applied, {completed_in_window} complete on the device in"
        f" {run.seconds} s; {len(book.waves)} waves in the run, {obs['captures']} captured in the window; p50 latency"
        f" {float(np.percentile(np.array(latency), 50)) if latency else math.nan:.2f} ms; mean wave {obs['mean_wave']:.1f} requests;"
        f" latency by third of the window {obs['latency_by_third_ms']} ms;"
        f" requests completed in each quarter of it {obs['completed_by_quarter']}"
    )

    # the reference
    ref = _spec.plugin("reference", cfg["reference"])
    ks = ref.top_ks(cfg["collection"])
    flat_logits, flat_target = logits.view(-1, logits.shape[-1]), target.view(-1)
    want_rows = ref.row_outcomes(flat_logits, flat_target, ks)
    ctl_rows = ref.row_outcomes(flat_logits, flat_target, ks, dtype=getattr(torch, run.control)) if run.control else None
    offsets = torch.arange(rows, device=device)
    gaps = Gaps()

    def tenant_values(outcome, blocks):
        idx = (torch.as_tensor(blocks, device=device)[:, None] * rows + offsets[None, :]).reshape(-1)
        cnt = {
            "confmat": ref.confusion(flat_target[idx], outcome["pred"][idx], c),
            "hits": {k: int(h[idx].sum()) for k, h in outcome["hits"].items()},
            "rows": int(idx.numel()),
        }
        return {key: ref.member_value(s, cnt) for key, s in cfg["collection"].items()}

    for t in range(tenants):
        if not book.applied[t]:
            continue
        want = tenant_values(want_rows, book.applied[t])
        got = tenant_values(ctl_rows, book.applied[t]) if ctl_rows is not None else got_values.get(t, {})
        for key, w in want.items():
            gaps.value(got.get(key), w)
    return {
        "e2e": e2e,
        "obs": obs,
        "numbers": gaps.numbers(),
        "compared": gaps.compared,
        "attempted": last - first,
        "failed": failed,
        "peak_bytes": peak,
        "profile": profile,
    }

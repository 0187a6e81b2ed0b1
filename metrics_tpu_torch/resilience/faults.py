"""Deterministic fault injection for the host-level store sync
(counterpart of ``metrics_tpu/resilience/faults.py``).

The group exchange in ``parallel/groups.py`` talks to a key-value store
through four calls, the JAX package's client protocol:
``key_value_set_bytes(key, value)``,
``blocking_key_value_get_bytes(key, timeout_ms)``,
``wait_at_barrier(barrier_id, timeout_ms, process_ids)`` and
``key_value_delete(key)``. On a ``torch.distributed`` world the
:class:`~metrics_tpu_torch.parallel.groups.StoreClient` speaks it over the
world's ``Store``; everything here impersonates or wraps that client, so
that every failure the retry and degradation machinery handles (a dropped
peer, a slow read, a corrupted payload, a straggler publishing late) can be
produced on demand, deterministically, in one CPU process:

* :class:`FaultSpec` / :class:`FaultPlan`: declarative faults keyed by the
  *publisher* rank and the exchange epoch (parsed from the key itself).
* :class:`InMemoryKVStore`: a thread-shared fake store. ``store.client(rank)``
  hands out per-rank clients; each simulated rank runs the real exchange
  against it on its own thread (:func:`run_as_peers`). Its protocol is the
  JAX package's, so a JAX peer and a port peer can share one store.
* :func:`simulated_world`: overrides, for the current thread, both the
  client and the (rank, world) identity that ``torch.distributed`` would
  otherwise give. ContextVars are per thread, so N threads simulate N
  processes.
* :class:`FaultyClient` / :func:`maybe_wrap_client`: the same plan around a
  live client, switched on by the ``METRICS_TPU_FAULTS`` variable (inline
  JSON, or ``@/path/to/plan.json``).

The ``kill``, ``die``, ``slow``, ``flaky`` and ``bitflip`` kinds are parsed
and kept as in the JAX package; the KV layers honour ``slow`` and
``flaky``, and the serving and fleet layers that consume the others come
with them.
"""
import contextlib
import contextvars
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "FaultPlan",
    "FaultSpec",
    "FaultyClient",
    "InMemoryKVStore",
    "InjectedFaultError",
    "KVTimeoutError",
    "corrupt_bytes",
    "current_client",
    "maybe_wrap_client",
    "parse_plan",
    "plan_from_env",
    "run_as_peers",
    "simulated_process",
    "simulated_world",
]

FAULTS_ENV_VAR = "METRICS_TPU_FAULTS"

_FAULT_KINDS = ("drop", "delay", "corrupt", "straggler", "kill", "die", "slow", "flaky", "bitflip")

# defined in utils.exceptions (a root export) and re-exported here
from metrics_tpu_torch.utils.exceptions import InjectedFaultError  # noqa: E402,F401


class KVTimeoutError(TimeoutError):
    """Timeout raised by the fake store — message mirrors the real
    coordination-service client (``DEADLINE_EXCEEDED``) so the transient-error
    classifier in ``parallel/groups.py`` treats both identically."""


@dataclass(frozen=True)
class FaultSpec:
    """One injected fault.

    Args:
        kind: ``'drop'`` — the publisher's payload is never stored;
            ``'straggler'`` — the publish only becomes visible ``seconds``
            after it happens; ``'delay'`` — every read of the payload takes an
            extra ``seconds`` (timing out the attempt if its budget is
            smaller); ``'corrupt'`` — the first ``times`` reads return
            bit-flipped bytes, later reads the true payload; ``'kill'`` —
            consumed by the elastic fleet layer (ROADMAP §1 item 10), not
            the KV fake: the worker whose integer id is ``rank`` dies the
            moment it is asked to admit a migrating tenant at fleet-epoch
            version ``epoch`` (the mid-migration worker-kill scenario — the
            payload survives in the migration ledger and a surviving worker
            re-admits it); ``'die'`` — like ``'kill'``, but a whole-PROCESS
            crash: the felled worker's bank and router objects are dropped
            before recovery starts (no graceful export, un-flushed requests
            lost), so recovery must come entirely from the durable spill
            store (``serving/store.py``). KV-level operations never consult
            kill/die specs. ``'slow'`` — a GRAY failure: the target stays up
            but every operation takes an extra ``seconds`` *within* its
            budget (KV fake/live wrapper: reads of the rank's payload sleep
            but do not time out on their own; fleet worker flush path: each
            batched apply sleeps before dispatching) — the worker is slow,
            not dead, which no crash-stop detector sees; ``'flaky'`` — the
            other gray failure: operations fail intermittently and
            deterministically (the first ``times`` of every ``times + 1``
            calls raise :class:`InjectedFaultError`, then one succeeds, and
            the pattern repeats — ``times=1`` is a 50% error rate), on KV
            reads of the rank's payload and on the fleet worker's flush path.
            ``'bitflip'`` — SILENT data corruption (SDC): consumed by the
            serving layer, never the KV fake. The fleet worker whose integer
            id is ``rank`` flips one bit in a tenant's device-resident state
            *after* an applied update (the bank's post-update injection seam)
            for the first ``times`` flushes at matching ``epoch``, then
            heals. The flip site (leaf + bit offset) is derived
            deterministically from the flip's sequence index, so a run is
            reproducible; nothing raises — detection must come from the
            state-integrity plane (``resilience/integrity.py``).
        rank: the *publisher* process index whose payload is affected (for
            ``'kill'``/``'die'``, and for ``'slow'``/``'flaky'``/``'bitflip'``
            on the worker flush path: the fleet worker id).
        epoch: exchange epoch the fault applies to (for ``'kill'``/``'die'``/
            ``'slow'``/``'flaky'``/``'bitflip'`` consulted by the fleet: the
            fleet epoch version); ``None`` = every epoch.
        seconds: delay/straggler/slow duration.
        times: how many corrupted reads ``'corrupt'`` serves before healing;
            for ``'flaky'``: failures per ``times + 1`` calls (the error
            duty cycle); for ``'bitflip'``: how many flushes flip a bit
            before the fault heals.
    """

    kind: str
    rank: int
    epoch: Optional[int] = None
    seconds: float = 0.25
    times: int = 1

    def __post_init__(self) -> None:
        if self.kind not in _FAULT_KINDS:
            raise ValueError(f"Unknown fault kind {self.kind!r}; choose from {_FAULT_KINDS}")

    def matches(self, rank: int, epoch: Optional[int]) -> bool:
        if rank != self.rank:
            return False
        return self.epoch is None or epoch is None or epoch == self.epoch


def _parse_key(key: str) -> Optional[Tuple[int, int]]:
    """``.../{scope}/{epoch}/{rank}`` -> (epoch, rank); None for non-payload
    keys (barriers end in ``/done``)."""
    parts = key.rsplit("/", 2)
    if len(parts) != 3:
        return None
    try:
        return int(parts[1]), int(parts[2])
    except ValueError:
        return None


def corrupt_bytes(payload: bytes) -> bytes:
    """Deterministic corruption: flip one byte in the middle and one at the
    end — lands in the body for any real payload, so the crc32 envelope check
    must catch it."""
    if not payload:
        return b"\xff"
    buf = bytearray(payload)
    buf[len(buf) // 2] ^= 0xFF
    buf[-1] ^= 0xFF
    return bytes(buf)


class FaultPlan:
    """A set of :class:`FaultSpec` plus the mutable claim state that makes
    ``corrupt(times=N)`` deterministic across retries and threads."""

    def __init__(self, specs: Sequence[FaultSpec] = ()) -> None:
        self.specs = [s if isinstance(s, FaultSpec) else FaultSpec(**s) for s in specs]
        self._lock = threading.Lock()
        self._corrupt_served: Dict[Tuple[FaultSpec, int, int], int] = {}
        # per-spec call counters behind the deterministic 'flaky' duty cycle
        self._flaky_calls: Dict[FaultSpec, int] = {}
        # per-spec claims behind the deterministic 'bitflip' injection sites
        self._bitflips_served: Dict[FaultSpec, int] = {}

    def __iter__(self):
        return iter(self.specs)

    def __len__(self) -> int:
        return len(self.specs)

    def _first(self, kind: str, rank: int, epoch: Optional[int]) -> Optional[FaultSpec]:
        for spec in self.specs:
            if spec.kind == kind and spec.matches(rank, epoch):
                return spec
        return None

    def kills(self, rank: int, epoch: Optional[int] = None) -> bool:
        """True when the plan fells worker/rank ``rank`` at ``epoch`` — the
        fleet layer's mid-migration kill hook (see the ``'kill'`` kind)."""
        return self._first("kill", rank, epoch) is not None

    def dies(self, rank: int, epoch: Optional[int] = None) -> bool:
        """True when the plan crash-fells worker ``rank`` at ``epoch`` with
        whole-process semantics — the fleet drops the worker's bank/router
        objects and recovers from the durable store only (the ``'die'``
        kind)."""
        return self._first("die", rank, epoch) is not None

    def slow_s(self, rank: int, epoch: Optional[int] = None) -> float:
        """Injected gray latency for ``rank`` at ``epoch`` (0.0 when none) —
        consulted by the fleet worker flush path and, via
        :meth:`slow_read_s`, by the KV layers."""
        spec = self._first("slow", rank, epoch)
        return spec.seconds if spec else 0.0

    def flaky_fails(self, rank: int, epoch: Optional[int] = None) -> bool:
        """Whether THIS call against ``rank`` at ``epoch`` should fail with
        an :class:`InjectedFaultError` — deterministic duty cycle: the first
        ``times`` of every ``times + 1`` calls fail, then one succeeds, and
        the pattern repeats. Thread-safe (the counter is claimed under the
        plan lock, like ``corrupt``'s)."""
        spec = self._first("flaky", rank, epoch)
        if spec is None:
            return False
        with self._lock:
            n = self._flaky_calls.get(spec, 0)
            self._flaky_calls[spec] = n + 1
        return n % (spec.times + 1) < spec.times

    def bitflip_site(self, rank: int, epoch: Optional[int] = None) -> Optional[int]:
        """Claim one ``'bitflip'`` injection for worker ``rank`` at ``epoch``.

        Returns the flip's 0-based sequence index while the spec still owes
        flips (``times`` total, then the fault heals), else ``None``. The
        caller derives the corruption site (tenant slot, leaf, bit offset)
        deterministically from this index — see
        the serving layer's ``inject_bitflip`` (ROADMAP §1 item 8) — so a plan
        reproduces the exact same SDC every run. Thread-safe (claimed under
        the plan lock, like ``corrupt``'s counter)."""
        spec = self._first("bitflip", rank, epoch)
        if spec is None:
            return None
        with self._lock:
            served = self._bitflips_served.get(spec, 0)
            if served >= spec.times:
                return None
            self._bitflips_served[spec] = served + 1
        return served

    def slow_read_s(self, key: str) -> float:
        parsed = _parse_key(key)
        return self.slow_s(parsed[1], parsed[0]) if parsed else 0.0

    def flaky_read_fails(self, key: str) -> bool:
        parsed = _parse_key(key)
        return self.flaky_fails(parsed[1], parsed[0]) if parsed else False

    def drops_publish(self, key: str) -> bool:
        parsed = _parse_key(key)
        return bool(parsed and self._first("drop", parsed[1], parsed[0]))

    def publish_visible_delay_s(self, key: str) -> float:
        parsed = _parse_key(key)
        spec = parsed and self._first("straggler", parsed[1], parsed[0])
        return spec.seconds if spec else 0.0

    def read_delay_s(self, key: str) -> float:
        parsed = _parse_key(key)
        spec = parsed and self._first("delay", parsed[1], parsed[0])
        return spec.seconds if spec else 0.0

    def maybe_corrupt(self, key: str, value: bytes) -> bytes:
        parsed = _parse_key(key)
        if not parsed:
            return value
        epoch, rank = parsed
        spec = self._first("corrupt", rank, epoch)
        if spec is None:
            return value
        claim = (spec, epoch, rank)
        with self._lock:
            served = self._corrupt_served.get(claim, 0)
            if served >= spec.times:
                return value
            self._corrupt_served[claim] = served + 1
        return corrupt_bytes(value)


def parse_plan(text: str) -> FaultPlan:
    """Parse a JSON list of fault dicts, e.g.
    ``[{"kind": "drop", "rank": 1, "epoch": 0}]``.

    Strict: an unknown fault ``kind`` or an unknown field raises
    ``ValueError`` naming the offending spec's index and content — a typo'd
    ``METRICS_TPU_FAULTS`` entry must fail the run loudly at parse time, not
    silently inject nothing while the operator believes the fault is live."""
    specs = json.loads(text)
    if not isinstance(specs, list):
        raise ValueError(f"A fault plan must be a JSON list of fault objects, got {type(specs).__name__}")
    parsed = []
    for i, spec in enumerate(specs):
        if not isinstance(spec, dict):
            raise ValueError(
                f"Fault plan entry {i} must be an object, got {type(spec).__name__}: {spec!r}"
            )
        try:
            parsed.append(FaultSpec(**spec))
        except (TypeError, ValueError) as err:
            raise ValueError(
                f"Invalid fault plan entry {i} ({spec!r}): {err}."
                f" Known kinds: {_FAULT_KINDS};"
                " known fields: kind, rank, epoch, seconds, times."
            ) from err
    return FaultPlan(parsed)


def plan_from_env(environ: Optional[Dict[str, str]] = None) -> Optional[FaultPlan]:
    """Read ``METRICS_TPU_FAULTS`` — inline JSON, or ``@path`` to a JSON
    file. Returns None when unset/empty."""
    raw = (environ if environ is not None else os.environ).get(FAULTS_ENV_VAR, "").strip()
    if not raw:
        return None
    if raw.startswith("@"):
        with open(raw[1:]) as f:
            raw = f.read()
    return parse_plan(raw)


# ---------------------------------------------------------------------------
# in-memory coordination-service fake (single-process, multi-thread "ranks")
# ---------------------------------------------------------------------------
class InMemoryKVStore:
    """Thread-shared fake of the distributed runtime's KV/barrier service.

    ``store.client(rank)`` returns a per-rank binding exposing the four calls
    the sync stack uses; ``store.log`` records every (op, rank, key) for
    assertions like "retries stayed on the same epoch key".
    """

    def __init__(self, faults: Any = ()) -> None:
        self.faults = faults if isinstance(faults, FaultPlan) else FaultPlan(faults)
        self._cond = threading.Condition()
        self._data: Dict[str, Tuple[bytes, float]] = {}  # key -> (value, visible_at)
        self._barriers: Dict[str, set] = {}
        self.log: List[Tuple[str, int, str]] = []

    def client(self, rank: int) -> "_SimClient":
        return _SimClient(self, int(rank))

    # -- operations (rank-bound, called via _SimClient) -----------------
    def _set(self, rank: int, key: str, value: bytes) -> None:
        with self._cond:
            self.log.append(("set", rank, key))
            if self.faults.drops_publish(key):
                return
            visible_at = time.monotonic() + self.faults.publish_visible_delay_s(key)
            self._data[key] = (bytes(value), visible_at)
            self._cond.notify_all()

    def _get(self, rank: int, key: str, timeout_ms: int) -> bytes:
        deadline = time.monotonic() + timeout_ms / 1000.0
        with self._cond:
            self.log.append(("get", rank, key))
            while True:
                entry = self._data.get(key)
                if entry is not None and entry[1] <= time.monotonic():
                    value = entry[0]
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise KVTimeoutError(
                        f"DEADLINE_EXCEEDED: key {key!r} not available within {timeout_ms}ms"
                    )
                self._cond.wait(min(remaining, 0.005))
        read_delay = self.faults.read_delay_s(key)
        if read_delay:
            remaining = deadline - time.monotonic()
            if read_delay > remaining:  # the slow read overruns this attempt's budget
                time.sleep(max(0.0, remaining))
                raise KVTimeoutError(
                    f"DEADLINE_EXCEEDED: read of key {key!r} exceeded its {timeout_ms}ms budget"
                )
            time.sleep(read_delay)
        gray_slow = self.faults.slow_read_s(key)
        if gray_slow:
            # gray 'slow': latency inside the budget — the read still answers
            # (unlike 'delay', which models a read that can blow its attempt)
            time.sleep(min(gray_slow, max(0.0, deadline - time.monotonic())))
        if self.faults.flaky_read_fails(key):
            raise InjectedFaultError(f"UNAVAILABLE: injected flaky read of key {key!r}")
        return self.faults.maybe_corrupt(key, value)

    def _barrier(self, rank: int, barrier_id: str, timeout_ms: int, process_ids: Sequence[int]) -> None:
        needed = set(int(p) for p in process_ids)
        deadline = time.monotonic() + timeout_ms / 1000.0
        with self._cond:
            self.log.append(("barrier", rank, barrier_id))
            self._barriers.setdefault(barrier_id, set()).add(rank)
            self._cond.notify_all()
            while not needed.issubset(self._barriers[barrier_id]):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    missing = sorted(needed - self._barriers[barrier_id])
                    raise KVTimeoutError(
                        f"DEADLINE_EXCEEDED: barrier {barrier_id!r} missing ranks {missing}"
                        f" after {timeout_ms}ms"
                    )
                self._cond.wait(min(remaining, 0.005))

    def _delete(self, rank: int, key: str) -> None:
        with self._cond:
            self.log.append(("delete", rank, key))
            self._data.pop(key, None)
            self._cond.notify_all()


class _SimClient:
    """Per-rank binding of an :class:`InMemoryKVStore` — duck-types the
    distributed runtime client surface the sync stack uses."""

    def __init__(self, store: InMemoryKVStore, rank: int) -> None:
        self._store = store
        self.rank = rank

    def key_value_set_bytes(self, key: str, value: bytes) -> None:
        self._store._set(self.rank, key, value)

    def blocking_key_value_get_bytes(self, key: str, timeout_ms: int) -> bytes:
        return self._store._get(self.rank, key, timeout_ms)

    def wait_at_barrier(self, barrier_id: str, timeout_ms: int, process_ids: Optional[Sequence[int]] = None) -> None:
        self._store._barrier(self.rank, barrier_id, timeout_ms, process_ids or ())

    def key_value_delete(self, key: str) -> None:
        self._store._delete(self.rank, key)


# ---------------------------------------------------------------------------
# fault wrapper for a REAL distributed-runtime client (env-activated)
# ---------------------------------------------------------------------------
class FaultyClient:
    """Apply a :class:`FaultPlan` around a live coordination-service client.

    Used by ``groups._kv_client()`` when ``METRICS_TPU_FAULTS`` is set, so a
    real multi-process run (``chip_smoke.py`` phase 18) exercises the same
    retry/degradation paths the CPU harness does.
    Faults keyed by rank R bite on the host *publishing* as R (drop/straggler
    suppress or delay its own publish) and on any host *reading* R's payload
    (delay/corrupt).
    """

    def __init__(self, inner: Any, plan: FaultPlan) -> None:
        self._inner = inner
        self._plan = plan
        self._pending: Dict[str, threading.Timer] = {}
        self._pending_lock = threading.Lock()

    def key_value_set_bytes(self, key: str, value: bytes) -> None:
        if self._plan.drops_publish(key):
            return
        delay = self._plan.publish_visible_delay_s(key)
        if delay:
            # straggler semantics match the in-memory store: the publish
            # becomes VISIBLE late — the publisher itself is not blocked (its
            # exchange deadline keeps running against its peer reads only)
            timer = threading.Timer(delay, self._inner.key_value_set_bytes, args=(key, bytes(value)))
            timer.daemon = True
            with self._pending_lock:
                self._pending[key] = timer
            timer.start()
            return
        self._inner.key_value_set_bytes(key, value)

    def blocking_key_value_get_bytes(self, key: str, timeout_ms: int) -> bytes:
        delay = self._plan.read_delay_s(key)
        if delay:
            budget = timeout_ms / 1000.0
            if delay >= budget:
                time.sleep(budget)
                raise KVTimeoutError(
                    f"DEADLINE_EXCEEDED: injected read delay exceeded the {timeout_ms}ms budget for {key!r}"
                )
            time.sleep(delay)
            timeout_ms = max(1, int((budget - delay) * 1000))
        gray_slow = self._plan.slow_read_s(key)
        if gray_slow:
            # gray 'slow': latency within the budget, never a self-inflicted
            # timeout (the remaining budget is passed through to the client)
            gray_slow = min(gray_slow, max(0.0, timeout_ms / 1000.0 - 0.001))
            time.sleep(gray_slow)
            timeout_ms = max(1, int(timeout_ms - gray_slow * 1000))
        if self._plan.flaky_read_fails(key):
            raise InjectedFaultError(f"UNAVAILABLE: injected flaky read of key {key!r}")
        value = self._inner.blocking_key_value_get_bytes(key, timeout_ms)
        return self._plan.maybe_corrupt(key, value)

    def key_value_delete(self, key: str) -> None:
        # a delayed (straggler) publish still in flight must not land AFTER
        # the exchange's cleanup and leak a coordination-service entry
        with self._pending_lock:
            timer = self._pending.pop(key, None)
        if timer is not None:
            timer.cancel()
        self._inner.key_value_delete(key)

    def __getattr__(self, name: str) -> Any:  # barrier/etc pass through
        return getattr(self._inner, name)


_env_wrapped: Dict[int, FaultyClient] = {}
_ENV_PLAN_UNSET = object()
_env_plan: Any = _ENV_PLAN_UNSET  # parsed once per process; None = "no plan"


def maybe_wrap_client(client: Any) -> Any:
    """Wrap ``client`` in a :class:`FaultyClient` when ``METRICS_TPU_FAULTS``
    is set; otherwise return it unchanged. This sits on the hot sync path, so
    everything is cached: the env plan is parsed once per process (including
    the common negative "no plan" result), and the wrapper is cached per
    client so ``corrupt(times=N)`` accounting survives across exchanges."""
    global _env_plan
    wrapper = _env_wrapped.get(id(client))
    if wrapper is not None and wrapper._inner is client:
        return wrapper
    if _env_plan is _ENV_PLAN_UNSET:
        _env_plan = plan_from_env()
    if _env_plan is None or not len(_env_plan):
        return client
    wrapper = FaultyClient(client, _env_plan)
    _env_wrapped[id(client)] = wrapper
    return wrapper


# ---------------------------------------------------------------------------
# per-thread world simulation (ContextVars are thread-local by default)
# ---------------------------------------------------------------------------
_CLIENT_OVERRIDE: "contextvars.ContextVar[Optional[Any]]" = contextvars.ContextVar(
    "metrics_tpu_torch_kv_client_override", default=None
)
_PROCESS_OVERRIDE: "contextvars.ContextVar[Optional[Tuple[int, int]]]" = contextvars.ContextVar(
    "metrics_tpu_torch_sim_process", default=None
)


def current_client() -> Optional[Any]:
    """The KV client override for the current thread, if any."""
    return _CLIENT_OVERRIDE.get()


def simulated_process() -> Optional[Tuple[int, int]]:
    """The simulated (rank, world) for the current thread, if any."""
    return _PROCESS_OVERRIDE.get()


@contextlib.contextmanager
def simulated_world(rank: int, world: int, client: Any):
    """Run the enclosed code as simulated process ``rank`` of ``world``,
    talking to ``client`` instead of the real distributed runtime.

    Overrides are ContextVars: each thread sets its own, so N threads under
    :func:`run_as_peers` impersonate N processes concurrently.
    """
    token_c = _CLIENT_OVERRIDE.set(client)
    token_p = _PROCESS_OVERRIDE.set((int(rank), int(world)))
    try:
        yield
    finally:
        _CLIENT_OVERRIDE.reset(token_c)
        _PROCESS_OVERRIDE.reset(token_p)


def run_as_peers(
    world: int,
    fn: Callable[[int], Any],
    store: Optional[InMemoryKVStore] = None,
    faults: Any = (),
    timeout_s: float = 60.0,
) -> Dict[int, Any]:
    """Run ``fn(rank)`` for every rank on its own thread, each inside
    :func:`simulated_world` over a shared :class:`InMemoryKVStore`.

    Returns ``{rank: result}``; the first per-rank exception is re-raised in
    the caller after every thread has finished (so a failing exchange can't
    leave live threads mutating the store behind the test's back).
    """
    store = store if store is not None else InMemoryKVStore(faults)
    results: Dict[int, Any] = {}
    errors: Dict[int, BaseException] = {}

    def runner(rank: int) -> None:
        try:
            with simulated_world(rank, world, store.client(rank)):
                results[rank] = fn(rank)
        except BaseException as err:  # noqa: BLE001 — re-raised below
            errors[rank] = err

    threads = [threading.Thread(target=runner, args=(r,), daemon=True) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s)
    alive = [t for t in threads if t.is_alive()]
    if alive:
        raise RuntimeError(
            f"{len(alive)} simulated peer(s) still running after {timeout_s}s — "
            "a sync path hung past its group deadline"
        )
    if errors:
        rank = sorted(errors)[0]
        raise errors[rank]
    return results

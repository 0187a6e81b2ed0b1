"""Admission control and brownout (counterpart of
``metrics_tpu/resilience/overload.py``): degrade gracefully, never melt down.

The front door of a serving plane refuses the work it cannot do, loudly:

* **Per-tenant token buckets**: one tenant's burst drains its own quota.
* **Global inflight cap**: past it, admission sheds instead of queueing.
* **Deadline-aware shedding**: a request with ``deadline_s`` that cannot
  meet it (the owner router's flush deadline plus the bank's flush latency)
  is rejected at once, while the caller can still act.
* **Retry budgets**: retries draw from a separate, smaller bucket.
* **Loud, never silent**: every shed raises
  :class:`~metrics_tpu_torch.utils.exceptions.OverloadError` naming the
  tenant, the reason and the pressure, counts into :meth:`summary` and
  emits a ``shed`` event.
* **Brownout**: after ``brownout_after`` hot ticks in a row the controller
  stretches the fleet's flush deadlines and checkpoint cadences by
  ``brownout_stretch``, and restores them after ``brownout_recover_after``
  cool ticks; both edges emit ``guard`` events.

The controller is threadless and clock-driven (the clock is injectable):
decisions happen on :meth:`~AdmissionController.submit`, pressure tracking
on :meth:`~AdmissionController.tick`. It reads its ``inner`` object by duck
typing (``submit``, ``fleet``, ``pending_requests()``, ``owner_of``,
``_workers`` with their ``router`` and ``bank``), the surface of the JAX
package's fleet; ``obs.snapshot()["guard"]`` stays unported until the
fleet's guard is ported (ROADMAP §1 item 10).
"""
import itertools
import threading
import time
import weakref
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

from metrics_tpu_torch.obs import bus as _bus
from metrics_tpu_torch.utils.exceptions import OverloadError

__all__ = ["SHED_REASONS", "AdmissionController", "TokenBucket", "all_controllers", "overload_summary"]

_CONTROLLERS: "weakref.WeakSet[AdmissionController]" = weakref.WeakSet()
_REGISTRY_LOCK = threading.Lock()
_CONTROLLER_IDS = itertools.count()

SHED_REASONS = ("tenant_quota", "inflight", "deadline", "retry_budget")

#: per-tenant bucket map bound — beyond it, the least-recently-used
#: tenant's bucket is dropped (it refills from full on its next request)
_TENANT_BUCKET_CAP = 4096


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill, ``burst`` capacity.

    ``try_take`` is non-blocking — admission control never waits; it admits
    or sheds. The clock is injectable for deterministic tests.
    """

    __slots__ = ("rate", "burst", "_tokens", "_t", "_clock")

    def __init__(self, rate: float, burst: float, clock: Callable[[], float] = time.monotonic) -> None:
        if rate <= 0 or burst <= 0:
            raise ValueError(f"rate and burst must be > 0, got rate={rate}, burst={burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._clock = clock
        self._t = clock()

    def _refill(self) -> None:
        now = self._clock()
        self._tokens = min(self.burst, self._tokens + (now - self._t) * self.rate)
        self._t = now

    def try_take(self, n: float = 1.0) -> bool:
        self._refill()
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    @property
    def tokens(self) -> float:
        self._refill()
        return self._tokens


def all_controllers() -> List["AdmissionController"]:
    with _REGISTRY_LOCK:
        return sorted(_CONTROLLERS, key=lambda c: c.name)


class AdmissionController:
    """Admission control at the request-plane face.

    Args:
        inner: where admitted requests go: anything with
            ``submit(tenant, *args)`` (a fleet's guard, router or the fleet
            itself, as in the JAX package). The controller resolves the
            underlying fleet from ``inner.fleet`` when present.
        tenant_rate / tenant_burst: per-tenant token-bucket quota
            (requests/s and burst size); ``None`` rate disables quotas.
        max_inflight: global cap on queued-but-unapplied requests across
            the fleet's routers; ``None`` disables the cap.
        retry_rate / retry_burst: the retry budget — ``submit(retry=True)``
            draws from this bucket *in addition to* the tenant quota, so
            retry storms are capped independently of fresh traffic
            (``None`` rate admits retries like fresh requests).
        brownout_after: consecutive hot ticks (shed happened, or inflight
            ≥ ``brownout_enter_ratio`` of the cap) before brownout engages;
            ``None`` disables brownout.
        brownout_recover_after: consecutive cool ticks before restore.
        brownout_enter_ratio: inflight/cap ratio that makes a tick hot.
        brownout_stretch: multiplier applied to every worker router's
            ``max_delay_s`` and every bank's checkpoint cadence while
            browned out.
        name: telemetry label (defaults to ``overload<N>``).
        clock: time source (injectable for deterministic tests).
    """

    def __init__(
        self,
        inner: Any,
        *,
        tenant_rate: Optional[float] = None,
        tenant_burst: Optional[float] = None,
        max_inflight: Optional[int] = None,
        retry_rate: Optional[float] = None,
        retry_burst: Optional[float] = None,
        brownout_after: Optional[int] = 3,
        brownout_recover_after: int = 3,
        brownout_enter_ratio: float = 0.8,
        brownout_stretch: float = 4.0,
        name: Optional[str] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.inner = inner
        self.fleet = getattr(inner, "fleet", inner)
        self.name = name if name is not None else f"overload{next(_CONTROLLER_IDS)}"
        self.tenant_rate = tenant_rate
        self.tenant_burst = float(tenant_burst if tenant_burst is not None else (tenant_rate or 1.0))
        self.max_inflight = max_inflight
        self.retry_rate = retry_rate
        self.retry_burst = float(retry_burst if retry_burst is not None else (retry_rate or 1.0))
        self.brownout_after = brownout_after
        self.brownout_recover_after = max(1, int(brownout_recover_after))
        self.brownout_enter_ratio = float(brownout_enter_ratio)
        self.brownout_stretch = float(brownout_stretch)
        self._clock = clock
        self._lock = threading.RLock()
        self._tenant_buckets: Dict[Hashable, TokenBucket] = {}
        self._retry_bucket = (
            TokenBucket(retry_rate, self.retry_burst, clock) if retry_rate is not None else None
        )
        self._hot_ticks = 0
        self._cool_ticks = 0
        self._shed_this_tick = False
        self.brownout_active = False
        # (router, original max_delay_s) / (bank, original cadence) to
        # restore on brownout exit
        self._stretched: List[Tuple[Any, Any, Any]] = []
        self.stats: Dict[str, int] = {
            "admitted": 0,
            "sheds": 0,
            **{f"shed_{reason}": 0 for reason in SHED_REASONS},
            "retries_admitted": 0,
            "brownouts_entered": 0,
            "brownouts_exited": 0,
            "inflight_peak": 0,
        }
        with _REGISTRY_LOCK:
            _CONTROLLERS.add(self)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def _inflight(self) -> int:
        pending = getattr(self.fleet, "pending_requests", None)
        return pending() if pending is not None else 0

    def _tenant_bucket(self, tenant: Hashable) -> Optional[TokenBucket]:
        if self.tenant_rate is None:
            return None
        bucket = self._tenant_buckets.get(tenant)
        if bucket is None:
            if len(self._tenant_buckets) >= _TENANT_BUCKET_CAP:
                # drop the oldest-inserted bucket; a returning tenant
                # restarts from a FULL bucket (generous, bounded memory)
                self._tenant_buckets.pop(next(iter(self._tenant_buckets)))
            bucket = self._tenant_buckets[tenant] = TokenBucket(
                self.tenant_rate, self.tenant_burst, self._clock
            )
        else:
            # re-inserting keeps the map LRU-ordered by last use
            self._tenant_buckets.pop(tenant)
            self._tenant_buckets[tenant] = bucket
        return bucket

    def _estimate_wait_s(self, tenant: Hashable) -> float:
        """Conservative time-to-apply estimate for a request admitted NOW:
        the owner router's flush deadline (a queued request waits at most
        that long for its wave) plus the owner bank's observed flush-latency
        EWMA. Deliberately cheap — admission control must not cost more
        than the work it rejects."""
        fleet = self.fleet
        try:
            worker = fleet._workers[fleet.owner_of(tenant)]
        except Exception:  # noqa: BLE001 — no owner resolvable: no estimate
            return 0.0
        est = 0.0
        if worker.router is not None and worker.router.max_delay_s is not None:
            est += worker.router.max_delay_s
        if worker.bank is not None and worker.bank._flush_ms_ewma is not None:
            est += worker.bank._flush_ms_ewma / 1000.0
        return est

    def _shed(self, tenant: Hashable, reason: str, detail: str) -> None:
        with self._lock:
            self.stats["sheds"] += 1
            self.stats[f"shed_{reason}"] += 1
            self._shed_this_tick = True
        if _bus.enabled():
            _bus.emit(
                "shed",
                source=self.name,
                fleet=getattr(self.fleet, "name", None),
                tenant=str(tenant),
                reason=reason,
                detail=detail,
            )
        raise OverloadError(
            f"{self.name}: request for tenant {tenant!r} shed ({reason}): {detail}."
            " Shed requests are NOT queued — back off and retry with"
            " submit(retry=True), which draws from the bounded retry budget.",
            reason=reason,
            tenant=tenant,
        )

    def submit(
        self,
        tenant: Hashable,
        *args: Any,
        deadline_s: Optional[float] = None,
        retry: bool = False,
    ) -> Any:
        """Admit-and-forward one request, or raise
        :class:`~metrics_tpu_torch.utils.exceptions.OverloadError`.

        Checks, in order: retry budget (for ``retry=True`` — the retry
        *attempt* is the pressure the budget caps, so it is drawn first),
        global inflight cap, deadline feasibility, and the per-tenant quota
        LAST — a token is only consumed once every other check passed, so a
        fleet-wide burst shedding on the inflight cap cannot drain a
        well-behaved tenant's own quota. An admitted request is forwarded
        to ``inner.submit`` and returns its result (a request id when
        ``inner`` is a fleet guard)."""
        if retry and self._retry_bucket is not None:
            with self._lock:
                ok = self._retry_bucket.try_take()
            if not ok:
                self._shed(tenant, "retry_budget", "the retry budget is exhausted")
        if self.max_inflight is not None:
            inflight = self._inflight()
            with self._lock:
                self.stats["inflight_peak"] = max(self.stats["inflight_peak"], inflight)
            if inflight >= self.max_inflight:
                self._shed(
                    tenant, "inflight", f"{inflight} requests inflight >= cap {self.max_inflight}"
                )
        if deadline_s is not None:
            est = self._estimate_wait_s(tenant)
            if est > deadline_s:
                self._shed(
                    tenant,
                    "deadline",
                    f"estimated time-to-apply {est:.3f}s exceeds deadline {deadline_s:.3f}s",
                )
        with self._lock:
            # the take happens under the controller lock: concurrent submits
            # for one tenant must not race the bucket's read-modify-write
            bucket = self._tenant_bucket(tenant)
            quota_ok = bucket.try_take() if bucket is not None else True
        if not quota_ok:
            self._shed(
                tenant,
                "tenant_quota",
                f"tenant rate {self.tenant_rate}/s (burst {self.tenant_burst}) exceeded",
            )
        result = self.inner.submit(tenant, *args)
        with self._lock:
            self.stats["admitted"] += 1
            if retry:
                # counted only once every check passed: a retry shed on the
                # inflight cap or quota was never admitted
                self.stats["retries_admitted"] += 1
        return result

    # ------------------------------------------------------------------
    # brownout
    # ------------------------------------------------------------------
    def _pressure_hot(self) -> bool:
        with self._lock:
            shed = self._shed_this_tick
            self._shed_this_tick = False
        if shed:
            return True
        if self.max_inflight is not None:
            return self._inflight() >= self.brownout_enter_ratio * self.max_inflight
        return False

    def tick(self) -> bool:
        """One pressure-tracking tick (call from the serving loop's idle
        tick): count hot/cool ticks, enter brownout after
        ``brownout_after`` consecutive hot ones, exit after
        ``brownout_recover_after`` consecutive cool ones. Returns whether
        brownout is active after the tick."""
        if self.brownout_after is None:
            return False
        hot = self._pressure_hot()
        with self._lock:
            if hot:
                self._hot_ticks += 1
                self._cool_ticks = 0
            else:
                self._cool_ticks += 1
                self._hot_ticks = 0
            enter = not self.brownout_active and self._hot_ticks >= self.brownout_after
            exit_ = self.brownout_active and self._cool_ticks >= self.brownout_recover_after
        if enter:
            self._enter_brownout()
        elif exit_:
            self._exit_brownout()
        return self.brownout_active

    def _enter_brownout(self) -> None:
        """Stretch flush deadlines and checkpoint cadences fleet-wide:
        larger waves amortize launches, sparser checkpoints cut durability
        I/O — throughput bought with latency + recovery freshness, the
        documented brownout trade."""
        stretched: List[Tuple[Any, Any, Any]] = []
        for worker in list(self.fleet._workers.values()):
            if not worker.alive:
                continue
            router, bank = worker.router, worker.bank
            if router is not None and router.max_delay_s is not None:
                stretched.append(("router", router, router.max_delay_s))
                router.max_delay_s = router.max_delay_s * self.brownout_stretch
            if bank is not None and bank.checkpoint_cadence is not None:
                stretched.append(("bank", bank, bank.checkpoint_cadence))
                bank.set_checkpoint_cadence(
                    max(1, int(round(bank.checkpoint_cadence * self.brownout_stretch)))
                )
        with self._lock:
            self._stretched = stretched
            self.brownout_active = True
            self.stats["brownouts_entered"] += 1
        if _bus.enabled():
            _bus.emit(
                "guard",
                source=self.name,
                fleet=getattr(self.fleet, "name", None),
                event="brownout_enter",
                stretch=self.brownout_stretch,
                stretched=len(stretched),
            )

    def _exit_brownout(self) -> None:
        with self._lock:
            stretched, self._stretched = self._stretched, []
            self.brownout_active = False
            self.stats["brownouts_exited"] += 1
        for kind, obj, original in stretched:
            try:
                if kind == "router":
                    obj.max_delay_s = original
                else:
                    obj.set_checkpoint_cadence(original)
            except Exception:  # noqa: BLE001 — a dead worker's objects may be gone
                pass
        if _bus.enabled():
            _bus.emit(
                "guard",
                source=self.name,
                fleet=getattr(self.fleet, "name", None),
                event="brownout_exit",
                restored=len(stretched),
            )

    # ------------------------------------------------------------------
    # ops surface
    # ------------------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "fleet": getattr(self.fleet, "name", None),
                "brownout_active": self.brownout_active,
                "tenant_rate": self.tenant_rate,
                "max_inflight": self.max_inflight,
                "tenants_tracked": len(self._tenant_buckets),
                **self.stats,
            }


_OVERLOAD_AGGREGATE_KEYS = (
    "admitted",
    "sheds",
    *(f"shed_{reason}" for reason in SHED_REASONS),
    "retries_admitted",
    "brownouts_entered",
    "brownouts_exited",
)


def overload_summary() -> Dict[str, Any]:
    """Process-wide admission-control telemetry: aggregates over every live
    controller plus the per-controller summaries (the JAX package folds it
    into ``obs.snapshot()["guard"]``, which the port fills once the fleet's
    guard is ported)."""
    controllers = {c.name: c.summary() for c in all_controllers()}
    out: Dict[str, Any] = {key: 0 for key in _OVERLOAD_AGGREGATE_KEYS}
    out["brownout_active"] = any(c.get("brownout_active") for c in controllers.values())
    for summary in controllers.values():
        for key in _OVERLOAD_AGGREGATE_KEYS:
            out[key] += summary.get(key, 0)
    out["controllers"] = controllers
    return out

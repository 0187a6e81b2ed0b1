"""Gray-failure defense: health-scored workers, hysteresis, hedged submits
(counterpart of ``metrics_tpu/fleet/guard.py``).

Every recovery path before this module is *crash-stop*: a worker is alive
or it is dead (``kill``/``die``), and death is announced. The dominant
production failure mode at pod scale is neither — a worker that is merely
SLOW (a thermally throttled host, a congested NIC) or FLAKY (intermittent
RPC errors) keeps accepting traffic and stalls every tenant routed to it,
while every liveness check still passes. :class:`FleetGuard` is the layer
that sees it:

* **Health scoring from obs-bus signals.** The guard subscribes to the
  event bus and scores each worker from its bank's ``flush`` events —
  EWMA flush latency (the ``ms`` field), EWMA error rate (error-carrying
  flushes) — plus the bank's journal/checkpoint lag polled at observation
  time. No new instrumentation: an injected ``METRICS_TPU_FAULTS``
  ``slow``/``flaky`` worker and a genuinely sick host produce the same
  signals, because the injection rides the same flush path.
* **Hysteresis, not flapping.** Workers move healthy → probation →
  ejected only after ``probation_after``/``eject_after`` consecutive
  breaching observations, and probation heals back to healthy only after
  ``recover_after`` consecutive clean ones. One slow flush never ejects a
  worker; a persistently sick one cannot oscillate in and out of traffic.
* **Ejection rides the crash-stop machinery.** An ejected worker is
  ``Fleet.kill``'ed: its acked sessions recover from the durable spill
  store onto the surviving rendezvous owners and its un-flushed requests
  are re-submitted — gray failure is *converted into* the failure mode the
  fleet already survives bit-identically.
* **Hedged submits.** Every guarded submit carries a ``request_id``. A
  request still un-applied after its signature's pXX latency
  (``hedge_quantile`` over observed apply latencies, floored at
  ``min_hedge_delay_s``) is HEDGED: re-issued toward the tenant's
  rendezvous failover owner (``owners(tenant, epoch, k=2)[1]``). Because a
  metric accumulation is single-home (the tenant's state lives on exactly
  one bank), the hedge is *delivered* the moment the failover owner
  actually owns the tenant — which the guard itself makes prompt by
  ejecting the breaching primary, at which point rendezvous hands exactly
  the failover owner the tenant. The delivered hedge then RACES the kill
  path's resubmission of the original, and the fleet's shared
  :class:`~metrics_tpu_torch.serving.RequestDedup` applies exactly one of the
  two: ``duplicates_applied == 0`` is the proof. A hedge whose original
  lands first is cancelled, never applied.

Error absorption contract: once a request is accepted into a worker
router's queue, a *flush* failure (the gray symptom) is absorbed by the
guard — the router re-queued the request, the error is scored against the
worker, and the submitter is not bounced for the fleet's internal sickness.
A submission that never reached a queue (dead owner, validation error)
still raises. Admission control — rejecting work BEFORE it queues — is the
separate :class:`~metrics_tpu_torch.resilience.overload.AdmissionController`
layered in front.

Like the :class:`~metrics_tpu_torch.serving.RequestRouter`, the guard is
deliberately threadless and clock-driven: call :meth:`poll` from the
serving loop's idle tick; nothing happens from background threads, so
request application stays deterministic.

The default ``latency_threshold_ms`` is the JAX package's 250 ms. A bank's
flush time includes its cadence checkpoint (the fleet checkpoints every
flush by default), so on the card a healthy worker's flush of many large
tenants can take longer than that: set the threshold from a measured
healthy flush.
"""
import itertools
import threading
import time
import weakref
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

from metrics_tpu_torch.fleet import placement as _placement
from metrics_tpu_torch.obs import bus as _bus
from metrics_tpu_torch.obs import warn as _warn

__all__ = ["FleetGuard", "all_guards", "guard_stats"]

_GUARDS: "weakref.WeakSet[FleetGuard]" = weakref.WeakSet()
_GUARD_IDS = itertools.count()
_REGISTRY_LOCK = threading.Lock()
# bus custody: the state to restore is the one BEFORE the first open guard
# enabled the bus; the last close() restores it (per-guard snapshots would
# see "enabled by a sibling" and never restore)
_OPEN_GUARDS = 0
_BUS_WAS_ENABLED = False

#: worker health states, in degradation order
STATES = ("healthy", "probation", "ejected")

_EWMA_ALPHA = 0.3  # per-flush signal smoothing (latency ms / error rate)
_LAT_SAMPLES = 128  # per-signature apply-latency reservoir behind the pXX
_SIG_CAP = 64  # distinct signatures tracked before folding into "other"


def all_guards() -> List["FleetGuard"]:
    with _REGISTRY_LOCK:
        return sorted(_GUARDS, key=lambda g: g.name)


class _WorkerHealth:
    __slots__ = (
        "state",
        "ewma_ms",
        "err_ewma",
        "flushes",
        "errors",
        "samples",
        "seen_samples",
        "breach_streak",
        "clean_streak",
        "reasons",
        "audit_failures",
        "audit_bad_since_obs",
    )

    def __init__(self) -> None:
        self.state = "healthy"
        self.ewma_ms: Optional[float] = None
        self.err_ewma: Optional[float] = None
        self.flushes = 0
        self.errors = 0
        # total signal samples vs the count at the last observation: an
        # observation only advances the hysteresis streaks on FRESH
        # evidence, so an idle worker's stale EWMA cannot be re-counted
        # into an ejection (one slow flush must never eject a worker)
        self.samples = 0
        self.seen_samples = 0
        self.breach_streak = 0
        self.clean_streak = 0
        self.reasons: Tuple[str, ...] = ()
        # shadow-replay audit verdicts (integrity plane): a failed audit is
        # PROOF of corruption, not a latency inference — one failure per
        # observation window is a breach, scored through the same
        # probation->eject hysteresis as the gray signals
        self.audit_failures = 0
        self.audit_bad_since_obs = 0

    def observe_audit(self, ok: bool) -> None:
        self.samples += 1  # fresh evidence: the observe pass must not skip it
        if not ok:
            self.audit_failures += 1
            self.audit_bad_since_obs += 1

    def observe_flush(self, ms: Optional[float], error: bool) -> None:
        self.samples += 1
        if error:
            self.errors += 1
        else:
            self.flushes += 1
            if ms is not None:
                self.ewma_ms = (
                    ms if self.ewma_ms is None else (1 - _EWMA_ALPHA) * self.ewma_ms + _EWMA_ALPHA * ms
                )
        sample = 1.0 if error else 0.0
        self.err_ewma = (
            sample if self.err_ewma is None else (1 - _EWMA_ALPHA) * self.err_ewma + _EWMA_ALPHA * sample
        )

    def summary(self) -> Dict[str, Any]:
        return {
            "state": self.state,
            "ewma_ms": round(self.ewma_ms, 3) if self.ewma_ms is not None else None,
            "error_ewma": round(self.err_ewma, 4) if self.err_ewma is not None else None,
            "flushes": self.flushes,
            "errors": self.errors,
            "audit_failures": self.audit_failures,
            "breach_streak": self.breach_streak,
            "reasons": list(self.reasons),
        }


class _PendingReq:
    __slots__ = ("tenant", "args", "sig", "primary", "t_submit", "hedged", "failover")

    def __init__(self, tenant: Hashable, args: Tuple[Any, ...], sig: Any, primary: Hashable, now: float) -> None:
        self.tenant = tenant
        self.args = args
        self.sig = sig
        self.primary = primary
        self.t_submit = now
        self.hedged = False
        self.failover: Optional[Hashable] = None


def _make_subscriber(guard_ref: "weakref.ref[FleetGuard]") -> Callable[[Any], None]:
    # the bus holds subscribers strongly; a weakref-trampoline keeps a
    # dropped guard collectable (the trampoline unsubscribes itself on the
    # first event after collection)
    def _sub(event: Any) -> None:
        guard = guard_ref()
        if guard is None:
            _bus.unsubscribe(_sub)
            return
        guard._on_event(event)

    return _sub


class FleetGuard:
    """Gray-failure guard over one :class:`~metrics_tpu_torch.fleet.Fleet`.

    Args:
        fleet: the fleet to guard. Submissions should flow through
            :meth:`submit` (or an
            :class:`~metrics_tpu_torch.resilience.overload.AdmissionController`
            wrapping this guard) so they carry request ids and are tracked
            for hedging.
        latency_threshold_ms: flush-latency EWMA above this breaches.
        error_rate_threshold: flush-error EWMA (0..1) above this breaches.
        lag_threshold: journal/checkpoint lag (un-durable applied updates,
            ``MetricBank.checkpoint_lag``) above this breaches; ``None``
            (default) disables the lag signal.
        probation_after: consecutive breaching observations before a
            healthy worker enters probation.
        eject_after: consecutive breaching observations (counted anew in
            probation) before a probation worker is ejected.
        recover_after: consecutive clean observations healing probation
            back to healthy.
        hedge: arm hedges for stalled requests (default ``True``).
        hedge_quantile: the pXX of observed per-signature apply latencies
            used as the hedge delay (default 0.95).
        min_hedge_delay_s: hedge-delay floor, also used before a signature
            has enough samples (default 0.02).
        min_workers: never eject below this many live workers (default 1)
            — a fleet-wide gray event must degrade, not self-destruct.
        max_ejections: lifetime ejection budget (``None`` = unlimited).
        name: telemetry label (defaults to ``guard<N>``).
        clock: time source (injectable for deterministic tests).

    The guard enables the event bus (its signal source) on construction and
    restores the previous enabled state on :meth:`close`.
    """

    def __init__(
        self,
        fleet: Any,
        *,
        latency_threshold_ms: float = 250.0,
        error_rate_threshold: float = 0.5,
        lag_threshold: Optional[int] = None,
        probation_after: int = 2,
        eject_after: int = 2,
        recover_after: int = 3,
        hedge: bool = True,
        hedge_quantile: float = 0.95,
        min_hedge_delay_s: float = 0.02,
        min_workers: int = 1,
        max_ejections: Optional[int] = None,
        name: Optional[str] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.fleet = fleet
        self.name = name if name is not None else f"guard{next(_GUARD_IDS)}"
        self.latency_threshold_ms = float(latency_threshold_ms)
        self.error_rate_threshold = float(error_rate_threshold)
        self.lag_threshold = lag_threshold
        self.probation_after = max(1, int(probation_after))
        self.eject_after = max(1, int(eject_after))
        self.recover_after = max(1, int(recover_after))
        self.hedge = bool(hedge)
        self.hedge_quantile = float(hedge_quantile)
        self.min_hedge_delay_s = float(min_hedge_delay_s)
        self.min_workers = max(1, int(min_workers))
        self.max_ejections = max_ejections
        self._clock = clock
        self._lock = threading.RLock()
        self._health: Dict[Hashable, _WorkerHealth] = {}
        self._bank_to_worker: Dict[str, Hashable] = {}
        self._outstanding: Dict[str, _PendingReq] = {}
        self._lat: Dict[Any, List[float]] = {}
        self._rid = itertools.count()
        self.stats: Dict[str, int] = {
            "submitted": 0,
            "applied": 0,
            "hedges_armed": 0,
            "hedges_delivered": 0,
            "hedges_cancelled": 0,
            "ejections": 0,
            "ejections_skipped": 0,
            "ejection_errors": 0,
            "recoveries": 0,
            "probations": 0,
            "submit_errors_absorbed": 0,
            "flush_errors_absorbed": 0,
        }
        global _OPEN_GUARDS, _BUS_WAS_ENABLED
        with _REGISTRY_LOCK:
            if _OPEN_GUARDS == 0:
                _BUS_WAS_ENABLED = _bus.enabled()
            _OPEN_GUARDS += 1
            _GUARDS.add(self)
        _bus.enable()
        self._subscriber = _make_subscriber(weakref.ref(self))
        _bus.subscribe(self._subscriber)
        self._closed = False

    def close(self) -> None:
        """Detach from the bus. The guard stops scoring; outstanding request
        tracking is kept readable. The bus's prior enabled state is restored
        only when NO other live guard still depends on it — disabling a
        shared global out from under another fleet's guard would silently
        freeze its scoring."""
        global _OPEN_GUARDS
        if self._closed:
            return
        self._closed = True
        _bus.unsubscribe(self._subscriber)
        with _REGISTRY_LOCK:
            _OPEN_GUARDS -= 1
            restore = _OPEN_GUARDS == 0 and not _BUS_WAS_ENABLED
        if restore:
            _bus.disable()

    # ------------------------------------------------------------------
    # signal intake (bus subscriber — keep it tiny, it runs on the
    # emitting thread under no fleet lock guarantees)
    # ------------------------------------------------------------------
    def _worker_for_bank(self, bank_name: str) -> Optional[Hashable]:
        wid = self._bank_to_worker.get(bank_name)
        if wid is not None:
            return wid
        for wid, worker in dict(self.fleet._workers).items():
            self._bank_to_worker[worker.bank_name] = wid
        return self._bank_to_worker.get(bank_name)

    def _on_event(self, event: Any) -> None:
        if event.kind not in ("flush", "audit"):
            return
        bank = event.data.get("bank")
        if bank is None:
            return
        wid = self._worker_for_bank(bank)
        if wid is None:
            return
        with self._lock:
            rec = self._health.get(wid)
            if rec is None:
                rec = self._health[wid] = _WorkerHealth()
            if event.kind == "audit":
                rec.observe_audit(bool(event.data.get("ok")))
            else:
                rec.observe_flush(event.data.get("ms"), "error" in event.data)

    # ------------------------------------------------------------------
    # request plane: tracked, hedged submits
    # ------------------------------------------------------------------
    def _signature(self, args: Tuple[Any, ...]) -> Any:
        for worker in self.fleet._workers.values():
            if worker.router is not None:
                return worker.router._signature(args)
        return None

    def submit(self, tenant: Hashable, *args: Any) -> str:
        """Submit one tracked update request; returns its request id.

        The request is routed to the tenant's rendezvous owner with a fresh
        ``request_id``. A flush error after the request queued is absorbed
        (scored against the worker; the router re-queued the request — see
        the module docstring's error-absorption contract); a submission
        that never reached a queue re-raises."""
        rid = f"{self.name}:{next(self._rid)}"
        now = self._clock()
        primary = self.fleet.owner_of(tenant)
        rec = _PendingReq(tenant, args, self._signature(args), primary, now)
        with self._lock:
            self._outstanding[rid] = rec
            self.stats["submitted"] += 1
        try:
            self.fleet.submit(tenant, *args, request_id=rid)
        except Exception:
            if self.fleet.request_dedup.is_applied(tenant, rid) or self.fleet.has_pending_request(rid):
                with self._lock:
                    self.stats["submit_errors_absorbed"] += 1
            else:
                with self._lock:
                    # never queued: untrack AND uncount, so the documented
                    # submitted == applied convergence survives raised submits
                    self._outstanding.pop(rid, None)
                    self.stats["submitted"] -= 1
                raise
        return rid

    def _hedge_delay(self, sig: Any) -> float:
        samples = self._lat.get(sig if sig in self._lat else "other")
        if samples is None or len(samples) < 8:
            return self.min_hedge_delay_s
        ordered = sorted(samples)
        idx = min(len(ordered) - 1, int(self.hedge_quantile * len(ordered)))
        return max(self.min_hedge_delay_s, ordered[idx])

    def _record_latency(self, sig: Any, latency: float) -> None:
        key = sig
        if key not in self._lat and len(self._lat) >= _SIG_CAP:
            key = "other"
        samples = self._lat.setdefault(key, [])
        samples.append(latency)
        if len(samples) > _LAT_SAMPLES:
            del samples[: len(samples) - _LAT_SAMPLES]

    def _sweep_outstanding(self, now: float) -> None:
        # lock discipline: the guard lock is NEVER held across a call into
        # the fleet/bank layer (whose locks are held by threads that emit
        # bus events back into this guard) — snapshot under the lock, call
        # out unlocked, mutate per item under the lock
        dedup = self.fleet.request_dedup
        with self._lock:
            items = list(self._outstanding.items())
        for rid, rec in items:
            if dedup.is_applied(rec.tenant, rid):
                with self._lock:
                    if self._outstanding.pop(rid, None) is None:
                        continue
                    self._record_latency(rec.sig, now - rec.t_submit)
                    self.stats["applied"] += 1
                    if rec.hedged:
                        # the original landed before the hedge was ever
                        # deliverable: the hedge dies here, un-applied
                        self.stats["hedges_cancelled"] += 1
                if rec.hedged:
                    self._emit_hedge("cancelled", rid, rec, now)
                continue
            age = now - rec.t_submit
            if not rec.hedged:
                if self.hedge and age >= self._hedge_delay(rec.sig):
                    rec.hedged = True
                    epoch = self.fleet.epoch
                    rec.failover = (
                        _placement.owners(rec.tenant, epoch, k=2)[1] if epoch.size >= 2 else None
                    )
                    with self._lock:
                        self.stats["hedges_armed"] += 1
                    self._emit_hedge("armed", rid, rec, now)
                continue
            current = self.fleet.owner_of(rec.tenant)
            if current != rec.primary:
                # the failover owner took the tenant (ejection / kill /
                # resize): deliver the hedge copy. It races the kill path's
                # resubmission of the original — the shared dedup applies
                # exactly one of the two
                try:
                    self.fleet.submit(rec.tenant, *rec.args, request_id=rid)
                except Exception:
                    if not (
                        dedup.is_applied(rec.tenant, rid) or self.fleet.has_pending_request(rid)
                    ):
                        continue  # not delivered; retried next poll
                    with self._lock:
                        self.stats["submit_errors_absorbed"] += 1
                with self._lock:
                    self.stats["hedges_delivered"] += 1
                self._emit_hedge("delivered", rid, rec, now)
                # the delivery is a fresh tracked submission against the new
                # owner: it may itself stall, hedge, and fail over again
                rec.primary = current
                rec.hedged = False
                rec.t_submit = now

    def _emit_hedge(self, what: str, rid: str, rec: _PendingReq, now: float) -> None:
        if _bus.enabled():
            _bus.emit(
                "hedge",
                source=self.name,
                fleet=self.fleet.name,
                event=what,
                tenant=str(rec.tenant),
                request_id=rid,
                primary=str(rec.primary),
                failover=str(rec.failover) if rec.failover is not None else None,
                age_s=round(now - rec.t_submit, 6),
            )

    # ------------------------------------------------------------------
    # health scoring + state machine
    # ------------------------------------------------------------------
    def _breach_reasons(self, rec: _WorkerHealth, lag: Optional[int]) -> Tuple[str, ...]:
        reasons = []
        if rec.ewma_ms is not None and rec.ewma_ms > self.latency_threshold_ms:
            reasons.append("latency")
        if rec.err_ewma is not None and rec.err_ewma > self.error_rate_threshold:
            reasons.append("errors")
        if self.lag_threshold is not None and lag is not None and lag > self.lag_threshold:
            reasons.append("lag")
        if rec.audit_bad_since_obs > 0:
            reasons.append("integrity")
        return tuple(reasons)

    def _transition(
        self,
        wid: Hashable,
        rec: _WorkerHealth,
        new_state: str,
        events: List[Dict[str, Any]],
    ) -> None:
        old = rec.state
        rec.state = new_state
        rec.breach_streak = 0
        rec.clean_streak = 0
        if new_state == "probation":
            self.stats["probations"] += 1
        elif new_state == "healthy":
            self.stats["recoveries"] += 1
        events.append(
            dict(
                source=self.name,
                fleet=self.fleet.name,
                worker=str(wid),
                state_from=old,
                state_to=new_state,
                reasons=list(rec.reasons),
                ewma_ms=round(rec.ewma_ms, 3) if rec.ewma_ms is not None else None,
                error_ewma=round(rec.err_ewma, 4) if rec.err_ewma is not None else None,
            )
        )

    def _may_eject(self, alive: int) -> bool:
        if alive <= self.min_workers:
            return False
        if self.max_ejections is not None and self.stats["ejections"] >= self.max_ejections:
            return False
        return True

    def observe(self) -> Dict[Hashable, str]:
        """One scoring pass: evaluate every live worker's signals, advance
        the hysteresis state machine, eject workers whose probation breach
        streak exhausted. Returns ``{worker: state}``. Called by
        :meth:`poll`; callable directly for custom cadences."""
        # phase 1 — gather the polled signals with NO guard lock held (the
        # bank lock taken by checkpoint_lag is held by threads that emit
        # flush events back into this guard's subscriber)
        live: List[Tuple[Hashable, Optional[int]]] = []
        alive = 0
        for wid in list(self.fleet.epoch.workers):
            worker = self.fleet._workers.get(wid)
            if worker is None or not worker.alive:
                continue
            alive += 1
            lag = None
            if self.lag_threshold is not None and worker.bank is not None:
                lag = worker.bank.checkpoint_lag()
            live.append((wid, lag))
        # phase 2 — score + advance states under the guard lock (no calls
        # out); transitions and ejections are collected, not performed
        events: List[Dict[str, Any]] = []
        ejected: List[Hashable] = []
        capped: List[Hashable] = []
        with self._lock:
            for wid, lag in live:
                rec = self._health.setdefault(wid, _WorkerHealth())
                if rec.state == "ejected":
                    # the worker id is ALIVE and in the epoch again — a
                    # rejoin after ejection is a new serving cell and must
                    # be scored fresh, not shadowed by its predecessor's
                    # terminal record
                    rec = self._health[wid] = _WorkerHealth()
                rec.reasons = self._breach_reasons(rec, lag)
                breach = bool(rec.reasons)
                # an audit failure is consumed by the observation that scored
                # it — the integrity breach must not re-count on idle ticks
                rec.audit_bad_since_obs = 0
                # streaks advance only on FRESH evidence: new flush samples
                # since the last observation, or a live lag breach (polled
                # truth, not a cached EWMA). Re-counting a stale EWMA every
                # idle tick would walk a worker from one bad flush to
                # ejection with zero new signal.
                fresh = rec.samples != rec.seen_samples
                rec.seen_samples = rec.samples
                if not fresh and "lag" not in rec.reasons:
                    continue
                if rec.state == "healthy":
                    if breach:
                        rec.breach_streak += 1
                        if rec.breach_streak >= self.probation_after:
                            self._transition(wid, rec, "probation", events)
                    else:
                        rec.breach_streak = 0
                elif rec.state == "probation":
                    if breach:
                        rec.breach_streak += 1
                        rec.clean_streak = 0
                        if rec.breach_streak >= self.eject_after:
                            if self._may_eject(alive - len(ejected)):
                                self._transition(wid, rec, "ejected", events)
                                ejected.append(wid)
                                self.stats["ejections"] += 1
                            else:
                                rec.breach_streak = 0
                                self.stats["ejections_skipped"] += 1
                                capped.append(wid)
                    else:
                        rec.clean_streak += 1
                        rec.breach_streak = 0
                        if rec.clean_streak >= self.recover_after:
                            self._transition(wid, rec, "healthy", events)
            # prune records for workers that left the fleet gracefully —
            # the state gauges must count live workers, not every id ever
            # seen. Ejected records are kept: they document the terminal
            # state (and are replaced fresh if the id rejoins, above).
            members = set(self.fleet.epoch.workers)
            for wid in [
                w
                for w, rec in self._health.items()
                if rec.state != "ejected" and w not in members
            ]:
                del self._health[wid]
            states = {wid: rec.state for wid, rec in self._health.items()}
        # phase 3 — emit and act, unlocked
        if _bus.enabled():
            for payload in events:
                _bus.emit("guard", **payload)
        for wid in capped:
            _warn.warn_once(
                f"{self.name}: worker {wid!r} of fleet {self.fleet.name!r}"
                " keeps breaching but ejection is capped"
                " (min_workers/max_ejections); it stays in probation serving"
                " degraded.",
                key=("guard_eject_capped", self.name, wid),
            )
        for wid in ejected:
            try:
                # gray → crash-stop conversion: the durable store +
                # rendezvous recovery the fleet already has take over
                self.fleet.kill(wid)
            except Exception as err:  # noqa: BLE001 — state parked/retryable
                with self._lock:
                    self.stats["ejection_errors"] += 1
                _warn.warn_once(
                    f"{self.name}: ejection of worker {wid!r} raised"
                    f" ({type(err).__name__}: {err}); failed tenants are"
                    " parked in the migration ledger and re-admit on their"
                    " next submit/compute/resize.",
                    key=("guard_eject_error", self.name, wid),
                )
        return states

    def hold_probation(self, worker_id: Hashable) -> None:
        """Place ``worker_id`` in probation NOW, with a fresh health record
        — the rolling-upgrade canary hold (:meth:`Fleet.rolling_upgrade`).
        A canary build must EARN its way to healthy: it starts one breach
        observation from ejection-grade scrutiny (``eject_after`` applies
        from a zero streak) and heals to healthy only after
        ``recover_after`` consecutive clean observations, exactly like a
        worker that breached its way in."""
        with self._lock:
            rec = self._health[worker_id] = _WorkerHealth()
            rec.state = "probation"
            self.stats["probations"] += 1
        if _bus.enabled():
            _bus.emit(
                "guard",
                source=self.name,
                fleet=self.fleet.name,
                worker=str(worker_id),
                state_from="healthy",
                state_to="probation",
                reasons=["canary_hold"],
                ewma_ms=None,
                error_ewma=None,
            )

    # ------------------------------------------------------------------
    # the serving-loop tick
    # ------------------------------------------------------------------
    def _sweep_workers(self, flush: bool) -> int:
        """Per-worker router poll (or full flush), absorbing flush errors —
        one flaky worker's raise must not stop the other workers' ticks."""
        moved = 0
        for worker in list(self.fleet._workers.values()):
            if not worker.alive or worker.router is None:
                continue
            try:
                moved += worker.router.flush() if flush else worker.router.poll()
            except Exception:  # noqa: BLE001 — re-queued by the router, scored via the bus
                with self._lock:
                    self.stats["flush_errors_absorbed"] += 1
        return moved

    def poll(self) -> int:
        """One guard tick: deadline-poll every worker router (errors
        absorbed and scored), run one :meth:`observe` scoring pass (which
        may eject), then sweep outstanding requests — resolve applied ones
        into latency samples, arm hedges past their pXX delay, deliver
        armed hedges whose tenant moved to a new owner. Returns requests
        flushed by the router polls."""
        flushed = self._sweep_workers(flush=False)
        self.observe()
        self._sweep_outstanding(self._clock())
        return flushed

    def drain(self, max_rounds: int = 64) -> bool:
        """Poll + flush until every tracked request applied and no worker
        router holds pending requests (or ``max_rounds`` exhausted) — the
        end-of-epoch barrier for guarded traffic under gray faults (a flaky
        worker's duty cycle heals within a bounded number of retries)."""
        for _ in range(max_rounds):
            self.poll()
            with self._lock:
                settled = not self._outstanding
            if settled and not self._pending():
                return True
            self._sweep_workers(flush=True)
        self.poll()
        with self._lock:
            return not self._outstanding and not self._pending()

    def _pending(self) -> int:
        return self.fleet.pending_requests()

    # ------------------------------------------------------------------
    # ops surface
    # ------------------------------------------------------------------
    @property
    def outstanding(self) -> int:
        with self._lock:
            return len(self._outstanding)

    def worker_states(self) -> Dict[Hashable, str]:
        with self._lock:
            return {wid: rec.state for wid, rec in self._health.items()}

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            states = [rec.state for rec in self._health.values()]
            return {
                "fleet": self.fleet.name,
                "workers": {str(wid): rec.summary() for wid, rec in self._health.items()},
                "healthy": states.count("healthy"),
                "probation": states.count("probation"),
                "ejected": states.count("ejected"),
                "audit_failures": sum(r.audit_failures for r in self._health.values()),
                "outstanding": len(self._outstanding),
                "dedup": self.fleet.request_dedup.summary(),
                **self.stats,
            }


_GUARD_AGGREGATE_KEYS = (
    "submitted",
    "applied",
    "hedges_armed",
    "hedges_delivered",
    "hedges_cancelled",
    "ejections",
    "ejections_skipped",
    "ejection_errors",
    "audit_failures",
    "healthy",
    "probation",
    "ejected",
    "outstanding",
)


def guard_stats() -> Dict[str, Any]:
    """Process-wide gray-failure/overload telemetry — the ``"guard"``
    section of ``obs.snapshot()`` and the source of the
    ``metrics_tpu_guard_*`` Prometheus gauges: per-guard worker states and
    hedge counters, the exactly-once dedup proof counters, and the
    admission-control/brownout side from
    :mod:`metrics_tpu_torch.resilience.overload`."""
    from metrics_tpu_torch.resilience import overload as _overload

    guards = {g.name: g.summary() for g in all_guards()}
    out: Dict[str, Any] = {key: 0 for key in _GUARD_AGGREGATE_KEYS}
    out["duplicates_dropped"] = 0
    out["duplicates_applied"] = 0
    for summary in guards.values():
        for key in _GUARD_AGGREGATE_KEYS:
            out[key] += summary.get(key, 0)
        dedup = summary.get("dedup", {})
        out["duplicates_dropped"] += dedup.get("duplicates_dropped", 0)
        out["duplicates_applied"] += dedup.get("duplicates_applied", 0)
    out["guards"] = guards
    out["overload"] = _overload.overload_summary()
    return out

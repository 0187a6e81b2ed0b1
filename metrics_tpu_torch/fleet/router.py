"""The elastic fleet: workers, rendezvous routing, live migration
(counterpart of ``metrics_tpu/fleet/router.py``).

:class:`Fleet` makes serving cells a service whose size can change: each
member worker is one :class:`~metrics_tpu_torch.serving.MetricBank` fronted
by one :class:`~metrics_tpu_torch.serving.RequestRouter`, tenants are placed
by the coordination-free rendezvous hash over the versioned
:class:`~metrics_tpu_torch.fleet.FleetEpoch`, and a membership change moves
only the tenants rendezvous says must move, through the drain,
checkpoint-encode, publish and re-admit protocol of
:mod:`metrics_tpu_torch.fleet.migrate`.

:class:`FleetRouter` is the request-plane face: ``submit``/``poll``/``flush``
plus ``owner_of(tenant, epoch)``, the question any worker (or a stateless
front end) answers locally. The fleet-wide ``pending_detail()`` gathers each
worker router's per-signature view, so an operator sees which signature
group is deadline-flushing on which worker.

Failure story:

* **graceful leave**: drain, migrate out through the spill store (the same
  export route a crash recovery reads), decommission; bit-identical to
  never having had the worker.
* **kill**: the worker stops serving without cooperation. Recovery reads
  the worker's spill store (the bank's journal and sealed blobs, see
  ``serving/store.py``), never the dead bank's Python object: every acked
  session's payload is published to the migration ledger and re-admitted
  on the surviving rendezvous owners, and the dead router's un-flushed
  requests are re-submitted. With the fleet's default checkpoint cadence of
  1 the request stream is applied exactly once and the final values are
  bit-identical to a static fleet's.
* **die**: a whole-process crash: the worker's bank and router objects are
  gone (no graceful export, no re-submission). Recovery comes from the
  durable tier alone: acked (checkpointed) state restores bit-identically;
  requests that never reached a checkpoint are lost, which a ``DiskStore``
  with ``checkpoint_every_n_flushes=1`` makes empty.
* **mid-migration kill/die**: a ``METRICS_TPU_FAULTS`` plan entry of kind
  ``'kill'`` or ``'die'`` (``rank`` = integer worker id, ``epoch`` = fleet
  epoch version) fells the *destination* the moment it is asked to admit:
  the payload is still in the ledger (published before the source forgot
  the tenant), so the fleet re-routes to the next surviving owner with the
  pre-drain state intact.

On the card a bank owns its leaves, the CUDA graphs captured over them and
their memory pool. A worker that is decommissioned or dies drops its bank
and router (:meth:`Worker.forget_memory`), and with them the graphs and the
pool; nothing else of the fleet (its registry, a guard, a bus subscriber)
holds a bank. Workers' banks live on the template's device.
"""
import itertools
import threading
import time
import weakref
from typing import Any, Callable, Dict, Hashable, Iterable, List, Optional, Tuple

from metrics_tpu_torch.fleet import migrate as _migrate
from metrics_tpu_torch.fleet import placement as _placement
from metrics_tpu_torch.fleet.placement import FleetEpoch
from metrics_tpu_torch.obs import bus as _bus
from metrics_tpu_torch.resilience import faults as _faults
from metrics_tpu_torch.serving import store as _store
from metrics_tpu_torch.serving.dedup import RequestDedup
from metrics_tpu_torch.utils.exceptions import MetricsUserError

__all__ = ["Fleet", "FleetRouter", "Worker", "all_fleets", "fleet_summary"]

_FLEETS: "weakref.WeakSet[Fleet]" = weakref.WeakSet()
_FLEET_IDS = itertools.count()
_REGISTRY_LOCK = threading.Lock()


def all_fleets() -> List["Fleet"]:
    with _REGISTRY_LOCK:
        return sorted(_FLEETS, key=lambda f: f.name)


def fleet_summary() -> Dict[str, Any]:
    """Per-fleet membership/migration telemetry for every live fleet — the
    per-fleet half of ``obs.snapshot()["fleet"]`` and the source of the
    labelled ``metrics_tpu_fleet_*`` Prometheus gauges."""
    return {fleet.name: fleet.summary() for fleet in all_fleets()}


class Worker:
    """One serving cell: a worker id, a bank, and its request router.

    Workers are fleet-internal — requests enter through
    :meth:`Fleet.submit` / :class:`FleetRouter`, which route by rendezvous —
    but the object is public so tests and operators can inspect a specific
    worker's bank/router state.
    """

    def __init__(
        self,
        worker_id: Hashable,
        template: Any,
        capacity: int,
        *,
        bank_name: Optional[str] = None,
        max_requests: Optional[int] = None,
        max_delay_s: Optional[float] = 0.05,
        spill_store: Optional[Any] = None,
        checkpoint_every_n_flushes: Optional[int] = 1,
        request_dedup: Optional[RequestDedup] = None,
        fault_plan: Optional[Any] = None,
        epoch_fn: Optional[Any] = None,
        audit_rate: Optional[float] = None,
    ) -> None:
        from metrics_tpu_torch.serving import MetricBank, RequestRouter

        self.worker_id = worker_id
        self.alive = True
        self.bank: Optional[MetricBank] = MetricBank(
            template,
            capacity,
            name=bank_name or f"fleet:{worker_id}",
            spill_store=spill_store,
            checkpoint_every_n_flushes=checkpoint_every_n_flushes,
            request_dedup=request_dedup,
            audit_rate=audit_rate,
        )
        # gray-failure injection (METRICS_TPU_FAULTS 'slow'/'flaky' against
        # this worker's integer id): the injector rides the bank's flush
        # path INSIDE its latency/error accounting, so an injected gray
        # fault is observable through exactly the signals — flush-latency
        # EWMA, flush_errors, error-carrying flush events — a real slow or
        # flaky worker produces (what FleetGuard scores)
        self._fault_plan = fault_plan
        self._epoch_fn = epoch_fn
        if (
            fault_plan is not None
            and isinstance(worker_id, int)
            and any(s.kind in ("slow", "flaky") and s.rank == worker_id for s in fault_plan)
        ):
            self.bank.fault_injector = self._gray_inject
        # silent-data-corruption injection ('bitflip' against this worker's
        # id): the seam sits AFTER the bank's cadence checkpoint inside the
        # flush, so the flip strikes state already attested clean — the
        # shape real SDC takes between durability boundaries. Nothing raises
        # and no latency signal moves; only the integrity plane (digests at
        # the boundaries, sampled shadow-replay audits) can see it.
        if (
            fault_plan is not None
            and isinstance(worker_id, int)
            and any(s.kind == "bitflip" and s.rank == worker_id for s in fault_plan)
        ):
            self.bank.state_fault_injector = self._bitflip_inject
        # the durable identity survives a die(): recovery needs the store
        # and the journal namespace, never the bank object
        self.bank_name = self.bank.name
        self.store = self.bank.store
        self.router: Optional[RequestRouter] = RequestRouter(
            self.bank, max_requests=max_requests, max_delay_s=max_delay_s
        )
        self.stats: Dict[str, int] = {
            "migrations_in": 0,
            "migrations_out": 0,
            "bytes_in": 0,
            "bytes_out": 0,
        }

    @property
    def tenants(self) -> List[Hashable]:
        """Every session this worker holds (device-resident + store-spilled).
        After a die() the bank object is gone and the journal in the spill
        store is the authority."""
        if self.bank is None:
            live, _torn = _store.replay_journal(self.store, self.bank_name)
            return list(live)
        return self.bank.tenants + self.bank.spilled_tenants

    def forget_memory(self) -> None:
        """Simulate a whole-process crash: drop the bank and router objects.
        Only the spill store (and this shell's id/stats) remains readable —
        recovery MUST come from the durable tier. The bank's graphs and their
        pool go with it: its fault hooks (bound methods of this worker, a
        reference cycle) are cut, and its captured programs dropped even if
        a caller still holds the bank object."""
        bank = self.bank
        self.bank = None
        self.router = None
        if bank is not None:
            bank.fault_injector = None
            bank.state_fault_injector = None
            bank._resident.programs.clear()
            bank._resident.pool = None

    def _gray_inject(self) -> None:
        epoch = self._epoch_fn() if self._epoch_fn is not None else None
        slow = self._fault_plan.slow_s(self.worker_id, epoch)
        if slow:
            time.sleep(slow)
        if self._fault_plan.flaky_fails(self.worker_id, epoch):
            raise _faults.InjectedFaultError(
                f"UNAVAILABLE: injected flaky flush (worker {self.worker_id})"
            )

    def _bitflip_inject(self, tenants: List[Hashable]) -> None:
        from metrics_tpu_torch.resilience import integrity as _integrity

        epoch = self._epoch_fn() if self._epoch_fn is not None else None
        seq = self._fault_plan.bitflip_site(self.worker_id, epoch)
        if seq is None or not tenants:
            return
        _integrity.inject_bitflip(self.bank, tenants[seq % len(tenants)], seq=seq)

    def drain(self) -> int:
        """Flush the router so no request is in flight; returns requests
        flushed. The first step of every migration."""
        return self.router.flush() if self.router is not None else 0

    def export_payload(self, tenant: Hashable, precisions: Optional[Dict[str, str]] = None) -> bytes:
        """The tenant's sealed durable payload, read THROUGH the spill store
        (``MetricBank.export_payload`` checkpoints the session and hands back
        its blob — graceful leave drains through the same route a crash
        recovery reads). ``precisions`` re-encodes the payload with wire
        codec tags when lossy handoff was explicitly opted into."""
        return _migrate.reencode_payload(self.bank.export_payload(tenant), precisions)

    def summary(self) -> Dict[str, Any]:
        if self.bank is None:
            return {
                "alive": self.alive,
                "tenants": len(self.tenants),
                "resident": 0,
                "spilled": 0,
                "pending": 0,
                "died": True,
                **self.stats,
            }
        return {
            "alive": self.alive,
            "tenants": len(self.tenants),
            "resident": self.bank.occupancy,
            "spilled": len(self.bank.spilled_tenants),
            "pending": self.router.pending,
            **self.stats,
        }


class Fleet:
    """An elastic group of serving workers with rendezvous tenant placement.

    Args:
        template: the metric template every worker's bank serves (same
            bankability contract as :class:`~metrics_tpu_torch.serving.MetricBank`).
        workers: initial worker ids (any hashables; integer ids additionally
            make workers targetable by ``METRICS_TPU_FAULTS`` kill entries).
        capacity: device-resident tenant slots per worker bank.
        name: telemetry label (defaults to ``fleet<N>``).
        ledger: migration ledger (default in-process
            :class:`~metrics_tpu_torch.fleet.LocalLedger`; pass a
            :class:`~metrics_tpu_torch.fleet.KVLedger` to ship payloads over the
            coordination service / the simulated-world fault harness).
        max_delay_s / max_requests: per-worker router flush policy.
        fault_plan: explicit :class:`~metrics_tpu_torch.resilience.FaultPlan`
            consulted for ``'kill'`` entries (default: the env-activated
            ``METRICS_TPU_FAULTS`` plan).
        migration_precisions: wire codecs for migration payloads. Default
            ``None`` ships every state EXACT — unlike a sync exchange (where
            quantization is transient, re-derived from the exact carry every
            time), a migration's rounding would be baked into the tenant's
            stored state and compound across resizes, breaking the
            bit-identical recovery contract. Pass ``True`` to opt into the
            template's ``add_state(sync_precision=)`` tags, or an explicit
            ``{state: codec}`` dict, when lossy handoff is acceptable.
        durable_store: a shared :class:`~metrics_tpu_torch.serving.SpillStore`
            every worker's bank spills and journals into (per-worker
            namespacing rides the bank name, ``<fleet>:<worker>`` — give the
            fleet a stable ``name`` when recovery across process restarts
            matters). Default ``None``: each worker gets a private
            :class:`~metrics_tpu_torch.serving.MemoryStore` — kill recovery still
            flows through the store code route, but state lives only as
            long as THIS process. Pass a
            :class:`~metrics_tpu_torch.serving.DiskStore` for preemption-safe
            workers whose sessions survive a ``die()``/``kill -9``.
        checkpoint_every_n_flushes: per-worker bank durability cadence
            (default ``1``: every applied request batch is checkpointed into
            the store, so kill/die recovery is bit-identical to the last
            applied request — the tested contract; raise it to trade
            recovery freshness for lower checkpoint overhead, ``None``
            disables periodic checkpoints entirely).
    """

    def __init__(
        self,
        template: Any,
        workers: Iterable[Hashable],
        capacity: int,
        *,
        name: Optional[str] = None,
        ledger: Optional[_migrate.MigrationLedger] = None,
        max_requests: Optional[int] = None,
        max_delay_s: Optional[float] = 0.05,
        fault_plan: Optional[Any] = None,
        migration_precisions: Optional[Any] = None,
        durable_store: Optional[Any] = None,
        checkpoint_every_n_flushes: Optional[int] = 1,
        audit_rate: Optional[float] = None,
    ) -> None:
        ids = list(workers)
        if not ids:
            raise ValueError("a Fleet needs at least one worker")
        self.name = name if name is not None else f"fleet{next(_FLEET_IDS)}"
        self._template = template.clone()
        self.capacity = int(capacity)
        self._max_requests = max_requests
        self._max_delay_s = max_delay_s
        self.ledger = ledger if ledger is not None else _migrate.LocalLedger()
        if fault_plan is None:
            # resolved ONCE: re-reading METRICS_TPU_FAULTS (possibly an
            # @path file) per admission would put disk I/O inside the
            # per-tenant migration loop
            from metrics_tpu_torch.resilience import faults as _faults

            fault_plan = _faults.plan_from_env()
        self._fault_plan = fault_plan
        self._migration_precisions = migration_precisions
        self._durable_store = durable_store
        self._ckpt_every = checkpoint_every_n_flushes
        self._audit_rate = audit_rate
        # tenant -> ledger key, from publish until the admission acks: the
        # retryability record behind the partial-rebalance failure contract
        self._in_flight: Dict[Hashable, str] = {}
        # (tenant, args, request_id) requests whose post-recovery
        # resubmission failed — replayed by the next resize (same
        # park-and-retry contract as _in_flight state; ids preserved so a
        # replayed request still dedups against its hedged twin)
        self._parked_requests: List[Tuple[Hashable, Tuple[Any, ...], Any]] = []
        # fleet-scoped exactly-once registry: every worker bank shares it,
        # so a hedge applied on the failover owner and the kill path's
        # resubmission of the same request cannot both count
        self.request_dedup = RequestDedup()
        # synthetic ids for resubmitted requests that arrived untagged — a
        # resubmission must be distinguishable "queued but flush failed"
        # vs "never queued" (only the latter may park; see _commit_epoch)
        self._resub_ids = itertools.count()
        self.epoch = FleetEpoch(ids, version=0)
        # rolling-upgrade seam: when set, _new_worker routes through this
        # factory so a joining worker can be a NEW-build cell (different
        # template/kernels) while sharing the fleet's durable identity
        # (store namespace, dedup registry) — see rolling_upgrade()
        self._worker_builder: Optional[Callable[[Hashable, "Fleet"], Optional[Worker]]] = None
        self._workers: Dict[Hashable, Worker] = {}
        for wid in self.epoch.workers:
            self._workers[wid] = self._new_worker(wid)
        self._tenants: "dict[Hashable, None]" = {}  # insertion-ordered known-tenant set
        self._lock = threading.RLock()
        self.stats: Dict[str, int] = {
            "epoch_changes": 0,
            "migrations": 0,
            "migration_failures": 0,
            "rebalance_bytes": 0,
            "joins": 0,
            "leaves": 0,
            "kills": 0,
            "dies": 0,
            "recovered_tenants": 0,
            "resubmitted_requests": 0,
            "upgrades": 0,
            "rollbacks": 0,
        }
        with _REGISTRY_LOCK:
            _FLEETS.add(self)

    # ------------------------------------------------------------------
    # placement / request plane
    # ------------------------------------------------------------------
    def _new_worker(self, wid: Hashable) -> Worker:
        if self._worker_builder is not None:
            worker = self._worker_builder(wid, self)
            if worker is not None:
                return worker
        return self.build_worker(wid)

    def build_worker(self, wid: Hashable, **overrides: Any) -> Worker:
        """Construct a worker wired into THIS fleet's shared identity — the
        ``<fleet>:<worker>`` store namespace, the fleet-scoped request dedup,
        the epoch clock — with any ctor keyword overridden. The building
        block a :meth:`rolling_upgrade` factory should use: pass
        ``template=`` (a new-build metric, e.g. different kernels/layout)
        and keep everything durable untouched, so the upgraded cell reads
        the same journal/blobs its predecessor sealed."""
        template = overrides.pop("template", None)
        capacity = overrides.pop("capacity", None)
        kwargs: Dict[str, Any] = dict(
            bank_name=f"{self.name}:{wid}",
            max_requests=self._max_requests,
            max_delay_s=self._max_delay_s,
            spill_store=self._durable_store,
            checkpoint_every_n_flushes=self._ckpt_every,
            request_dedup=self.request_dedup,
            fault_plan=self._fault_plan,
            epoch_fn=lambda: self.epoch.version,
            audit_rate=self._audit_rate,
        )
        kwargs.update(overrides)
        return Worker(
            wid,
            template if template is not None else self._template,
            capacity if capacity is not None else self.capacity,
            **kwargs,
        )

    def _precisions(self) -> Optional[Dict[str, str]]:
        """Migration payload codecs: EXACT unless the user opted in (see the
        ``migration_precisions`` arg — sync tags are transient per-exchange,
        migration rounding would be baked into the stored state)."""
        opt = self._migration_precisions
        if opt is None or opt is False:
            return None
        if opt is True:
            tags = {
                n: p
                for n, p in getattr(self._template, "_sync_precisions", {}).items()
                if p and p != "exact"
            }
            return tags or None
        return dict(opt) or None

    def owner_of(self, tenant: Hashable, epoch: Optional[FleetEpoch] = None) -> Hashable:
        """Who owns ``tenant`` at ``epoch`` (default: the current one) —
        pure rendezvous, no coordination, same answer on every peer."""
        return _placement.owner(tenant, epoch if epoch is not None else self.epoch)

    def worker(self, worker_id: Hashable) -> Worker:
        return self._workers[worker_id]

    @property
    def workers(self) -> List[Hashable]:
        return [w for w in self.epoch.workers]

    @property
    def tenants(self) -> List[Hashable]:
        with self._lock:
            return list(self._tenants)

    def _heal_in_flight(self, tenant: Hashable) -> None:
        """Complete a migration a failed resize left parked in the ledger
        (see :meth:`resize` failure semantics) before serving the tenant."""
        key = self._in_flight.get(tenant)
        if key is None:
            return
        old = self.epoch
        _dst, evolved = self._admit_from_ledger(tenant, key, old, reason="retry")
        if evolved.version != old.version:
            # the fault plan felled an owner DURING the heal: run the full
            # membership-change path, like kill() — its other tenants and
            # queued requests must be recovered, not stranded
            epoch, moves, total_bytes, pending, failures = self._recover_all_dead(evolved)
            failures += self._commit_epoch(
                old, epoch, moves, total_bytes, pending, reason="fault_plan"
            )
            self._raise_if_failed(failures)

    def submit(self, tenant: Hashable, *args: Any, request_id: Any = None) -> int:
        """Route one update request to the tenant's rendezvous owner;
        returns requests flushed as a side effect (router semantics).
        ``request_id`` tags the request for exactly-once apply through the
        fleet's shared :class:`~metrics_tpu_torch.serving.RequestDedup` — the
        contract hedged submits and kill-path resubmission rely on."""
        with self._lock:
            self._heal_in_flight(tenant)
            wid = self.owner_of(tenant)
            worker = self._workers[wid]
            if not worker.alive:
                raise MetricsUserError(
                    f"fleet {self.name!r}: owner {wid!r} of tenant {tenant!r} is dead"
                    " but still in the epoch — call kill()/resize() to advance"
                    " membership before routing more traffic."
                )
            self._tenants[tenant] = None
            return worker.router.submit(tenant, *args, request_id=request_id)

    def has_pending_request(self, request_id: Any) -> bool:
        """Whether a tagged request is still queued on some live worker's
        router — combined with ``request_dedup.is_applied``, this answers
        "did a submission whose flush raised at least land in a queue"
        (the :class:`~metrics_tpu_torch.fleet.FleetGuard` error-swallowing probe)."""
        with self._lock:
            return any(
                w.router is not None and w.router.has_request_id(request_id)
                for w in self._workers.values()
            )

    def pending_requests(self) -> int:
        """Fleet-wide queued-but-unapplied request count (live workers'
        routers) — the one pending sum `FleetRouter.pending`, the guard's
        drain barrier, and admission control's inflight cap all read."""
        with self._lock:
            return sum(
                w.router.pending
                for w in self._workers.values()
                if w.alive and w.router is not None
            )

    def poll(self) -> int:
        with self._lock:
            return sum(w.router.poll() for w in self._workers.values() if w.alive)

    def flush(self) -> int:
        with self._lock:
            return sum(w.router.flush() for w in self._workers.values() if w.alive)

    def compute(self, tenant: Hashable) -> Any:
        """The tenant's metric value from its owner's bank (drains first, so
        a just-submitted request is never silently pending)."""
        with self._lock:
            self._heal_in_flight(tenant)
            worker = self._workers[self.owner_of(tenant)]
            worker.drain()
            return worker.bank.compute(tenant)

    def compute_all(self) -> Dict[Hashable, Any]:
        """Every known tenant's value — partitioned by owner, ONE drain per
        worker and one batched ``compute_many`` per bank, not a
        drain + single-slot launch per tenant."""
        with self._lock:
            for tenant in list(self._in_flight):
                self._heal_in_flight(tenant)
            by_owner = _placement.partition_by_owner(list(self._tenants), self.epoch)
            out: Dict[Hashable, Any] = {}
            for wid, tenants in by_owner.items():
                if not tenants:
                    continue
                worker = self._workers[wid]
                worker.drain()
                out.update(worker.bank.compute_many(tenants))
            return out

    # ------------------------------------------------------------------
    # membership changes (control plane)
    # ------------------------------------------------------------------
    def join(self, *worker_ids: Hashable, manifest: Optional[Any] = None) -> Dict[Hashable, Tuple[Hashable, Hashable]]:
        """Add workers and rebalance. ``manifest`` (a warmup manifest
        path/dict; default: the live in-memory recording when
        ``engine.record_manifest()`` is active) captures each joining
        worker's bank programs BEFORE its first migrated-in tenant or routed
        flush."""
        self.stats["joins"] += len(worker_ids)
        return self.resize(tuple(self.epoch.workers) + worker_ids, manifest=manifest)

    def leave(self, *worker_ids: Hashable) -> Dict[Hashable, Tuple[Hashable, Hashable]]:
        """Gracefully decommission workers: drain, migrate their tenants to
        the surviving rendezvous owners, drop them from the fleet."""
        gone = set(worker_ids)
        unknown = gone - set(self.epoch.workers)
        if unknown:
            raise KeyError(
                f"fleet {self.name!r}: cannot decommission unknown worker(s)"
                f" {sorted(map(str, unknown))} — not members of epoch"
                f" v{self.epoch.version}."
            )
        self.stats["leaves"] += len(gone)
        # resize() itself decommissions workers that left the epoch
        return self.resize([w for w in self.epoch.workers if w not in gone])

    def resize(
        self, worker_ids: Iterable[Hashable], manifest: Optional[Any] = None
    ) -> Dict[Hashable, Tuple[Hashable, Hashable]]:
        """Advance to a new epoch holding exactly ``worker_ids``, migrating
        exactly the rendezvous-mandated tenants. Returns the move map
        ``{tenant: (source, dest)}`` actually performed.

        Failure semantics: migrations are isolated per tenant. A tenant whose
        move fails (corrupted/dropped ledger payload, admission error) keeps
        its state parked in the ledger (``_in_flight``); the epoch still
        commits, a ``MetricsUserError`` naming the failed tenants is raised
        AFTER commit, and the next ``submit``/``compute``/``resize`` touching
        such a tenant re-admits it from the ledger — a partial rebalance is
        loud and retryable, never a silent state fork."""
        with self._lock:
            old = self.epoch
            new = old.with_workers(worker_ids)
            for wid in new.workers:
                if wid not in self._workers:
                    self._workers[wid] = self._new_worker(wid)
                    self._warm_worker(self._workers[wid], manifest)
            # drain EVERY live router: migration must never overtake a
            # pending request (per-tenant order is the serving contract)
            for worker in self._workers.values():
                if worker.alive:
                    worker.drain()
            # old.size == 0 only after a total-loss kill: nothing to diff,
            # every surviving state is in the in-flight ledger sweep below
            moves = (
                _placement.placement_diff(list(self._tenants), old, new) if old.size else {}
            )
            final_epoch, performed, moved_bytes, failures = self._migrate_moves(moves, new)
            # a fault-plan kill mid-resize may leave dead workers still
            # holding tenants that were never scheduled to move — recover
            # them (and their un-flushed requests) exactly like kill() does
            final_epoch, recovered, bytes_rec, pending, rec_failures = self._recover_all_dead(
                final_epoch
            )
            performed.update(recovered)
            moved_bytes += bytes_rec
            failures += rec_failures
            # requests parked by an earlier failed resubmission replay with
            # this change's recovered requests (oldest first)
            pending = self._parked_requests + pending
            self._parked_requests = []
            # in-flight sweep: tenants parked in the ledger by an earlier
            # failed move (this resize or a prior one) re-admit toward the
            # new epoch — a resize is the universal retry
            for tenant, key in list(self._in_flight.items()):
                try:
                    dst, final_epoch = self._admit_from_ledger(
                        tenant, key, final_epoch, reason="retry"
                    )
                    performed.setdefault(tenant, (None, dst))
                    # a same-call failure that the sweep just completed (e.g.
                    # a corrupt-N-reads fault healing) is no longer a failure
                    failures = [(t, e) for t, e in failures if t != tenant]
                except Exception as err:  # noqa: BLE001 — isolated like any move
                    self.stats["migration_failures"] += 1
                    failures.append((tenant, err))
            failures += self._commit_epoch(old, final_epoch, performed, moved_bytes, pending)
            self._raise_if_failed(failures)
            return performed

    # ------------------------------------------------------------------
    # rolling upgrade
    # ------------------------------------------------------------------
    def _emit_upgrade(self, event: str, **fields: Any) -> None:
        if _bus.enabled():
            _bus.emit("upgrade", source=self.name, event=event, **fields)

    def _canary_breach(
        self, wid: Hashable, guard: Optional[Any], audit_failed: int
    ) -> Tuple[str, ...]:
        """Why the canary must be rolled back NOW, or ``()``. A canary is
        held to a stricter standard than a tenured worker: ANY breach
        reason the guard scores during the hold (integrity, latency,
        errors, lag) triggers rollback — the guard's own hysteresis exists
        to avoid ejecting a worker on one bad flush, but a brand-new build
        showing its first bad flush IS the signal the canary exists for."""
        reasons: List[str] = []
        if audit_failed > 0:
            reasons.append("integrity")
        worker = self._workers.get(wid)
        if worker is None or not worker.alive or wid not in self.epoch.workers:
            reasons.append("dead")
        if guard is not None:
            rec = guard.summary().get("workers", {}).get(str(wid))
            if rec is not None:
                if rec.get("state") == "ejected":
                    reasons.append("ejected")
                for reason in rec.get("reasons", ()):
                    if reason not in reasons:
                        reasons.append(reason)
        return tuple(dict.fromkeys(reasons))

    def rolling_upgrade(
        self,
        worker_factory: Callable[[Hashable, "Fleet"], Optional[Worker]],
        *,
        manifest: Optional[Any] = None,
        guard: Optional[Any] = None,
        canary_steps: int = 8,
        on_step: Optional[Callable[["Fleet"], Any]] = None,
    ) -> Dict[str, Any]:
        """Replace every worker with a ``worker_factory``-built cell, one at
        a time, with the first replacement held as a CANARY — automatic
        rollback to the old build on an integrity or latency breach, zero
        acked requests lost either way.

        Per worker: graceful :meth:`leave` (drain, migrate its tenants to
        the survivors through the ledger), then :meth:`join` the same id
        with ``worker_factory(wid, fleet)`` building the cell (return
        ``None`` to fall back to the default build; use
        :meth:`build_worker` to inherit the fleet's durable identity) —
        rendezvous hands the same id the same tenants back, so the upgrade
        is invisible to placement.

        The FIRST upgraded worker is the canary: its bank's shadow-replay
        audit is forced to every flush, ``guard.hold_probation`` (when a
        :class:`~metrics_tpu_torch.fleet.FleetGuard` is passed) pins it under
        probation-grade scrutiny, and for ``canary_steps`` observation
        rounds — ``on_step(fleet)`` is the caller's traffic pump — every
        audit verdict and guard breach reason is checked. A breach rolls
        back: the canary is :meth:`kill`'ed (its acked sessions recover
        from the durable store onto the survivors — a failed audit was
        already repaired in place from the journaled acked prefix, so what
        migrates back is the correct state), the old build rejoins under
        the same id, and the rollout aborts. No acked request is lost in
        either direction; un-flushed requests ride the kill path's
        resubmission.

        Returns a report: ``upgraded`` (ids now on the new build),
        ``canary``, ``rolled_back``, ``breach`` (reasons, or ``None``),
        ``audit`` (canary verdict counts)."""
        order = sorted(self.epoch.workers, key=str)
        if len(order) < 2:
            raise MetricsUserError(
                f"fleet {self.name!r}: rolling_upgrade needs at least 2 workers"
                f" (got {len(order)}) — the drained worker's tenants migrate to"
                " the survivors, and a canary rollback needs somewhere for the"
                " old build's state to live meanwhile. join() a second worker"
                " first, or rebuild a singleton fleet in place."
            )
        from metrics_tpu_torch.resilience.integrity import IntegrityAuditor

        canary_wid = order[0]
        upgraded: List[Hashable] = []
        audit_counts = {"checked": 0, "passed": 0, "failed": 0, "repaired": 0}
        report: Dict[str, Any] = {
            "workers": list(order),
            "canary": canary_wid,
            "upgraded": upgraded,
            "rolled_back": False,
            "breach": None,
            "audit": audit_counts,
        }
        for wid in order:
            self._emit_upgrade("drain", worker=str(wid), epoch=self.epoch.version)
            self.leave(wid)
            self._worker_builder = worker_factory
            try:
                self.join(wid, manifest=manifest)
            finally:
                self._worker_builder = None
            self.stats["upgrades"] += 1
            self._emit_upgrade("replace", worker=str(wid), epoch=self.epoch.version)
            if wid != canary_wid:
                upgraded.append(wid)
                if on_step is not None:
                    on_step(self)
                continue
            # -- canary hold: full-rate shadow audit + probation scrutiny
            canary = self._workers[wid]
            saved_cadence = (canary.bank.audit_rate, canary.bank._audit_period)
            canary.bank.audit_rate = 1.0
            canary.bank._audit_period = 1
            auditor = IntegrityAuditor(canary.bank)
            if guard is not None:
                guard.hold_probation(wid)
            self._emit_upgrade("canary_hold", worker=str(wid), steps=canary_steps)
            breach: Tuple[str, ...] = ()
            for _ in range(max(1, int(canary_steps))):
                if on_step is not None:
                    on_step(self)
                worker = self._workers.get(wid)
                if worker is not None and worker.alive and worker.bank is not None:
                    worker.drain()
                    verdict = auditor.poll()
                    for key in audit_counts:
                        audit_counts[key] += verdict[key]
                if guard is not None:
                    guard.observe()
                breach = self._canary_breach(wid, guard, audit_counts["failed"])
                if breach:
                    break
            if not breach:
                upgraded.append(wid)
                canary.bank.audit_rate, canary.bank._audit_period = saved_cadence
                self._emit_upgrade("canary_pass", worker=str(wid), audit=dict(audit_counts))
                continue
            # -- rollback: old build back under the same id, state through
            # the ledger/durable store — the tested crash-stop machinery
            self.stats["rollbacks"] += 1
            report["rolled_back"] = True
            report["breach"] = list(breach)
            self._emit_upgrade(
                "rollback", worker=str(wid), reasons=list(breach), audit=dict(audit_counts)
            )
            if wid in self.epoch.workers and wid in self._workers and self._workers[wid].alive:
                try:
                    self.kill(wid)
                except MetricsUserError:
                    # per-tenant failures are parked in the ledger; the
                    # rejoin below is the universal retry that re-admits them
                    pass
            if wid not in self.epoch.workers:
                self.join(wid)
            self._emit_upgrade("complete", rolled_back=True, upgraded=len(upgraded))
            return report
        self._emit_upgrade("complete", rolled_back=False, upgraded=len(upgraded))
        return report

    def _commit_epoch(
        self,
        old: FleetEpoch,
        epoch: FleetEpoch,
        performed: Dict[Hashable, Tuple[Hashable, Hashable]],
        moved_bytes: int,
        pending: List[Tuple[Hashable, Tuple[Any, ...], Any]],
        reason: Optional[str] = None,
    ) -> List[Tuple[Hashable, BaseException]]:
        """The shared membership-change epilogue (resize and kill): commit
        the epoch, decommission workers that left it, resubmit recovered
        requests, emit the ``fleet_epoch`` event with joined/left derived
        from the actual old→new membership (cascade kills included).
        Returns per-request resubmission failures (isolated like every
        other migration step — a failing resubmit must not drop the rest;
        its request parks in ``_parked_requests`` for the next resize)."""
        self.epoch = epoch
        # a shrink decommissions: workers out of the epoch must not keep
        # their capacity-sized device banks alive (or keep appearing in
        # poll/flush/telemetry). A worker still holding tenants or queued
        # requests (a failed export stranded them) stays registered so its
        # state remains reachable for the retry.
        for wid in [w for w in list(self._workers) if w not in epoch.workers]:
            worker = self._workers[wid]
            if not worker.tenants and (worker.router is None or not worker.router.pending):
                self._workers.pop(wid).forget_memory()
        self.stats["epoch_changes"] += 1
        resubmit_failures: List[Tuple[Hashable, BaseException]] = []
        for tenant, args, rid in pending:
            if rid is None:
                # tag untagged requests so a flush failure below is
                # distinguishable from an enqueue failure — and so a later
                # replay of a parked copy can never double-apply
                rid = f"{self.name}:resub:{next(self._resub_ids)}"
            try:
                self.stats["resubmitted_requests"] += 1
                # the original request id rides the resubmission: if a hedge
                # for this request was (or will be) delivered to the new
                # owner, the shared dedup applies exactly one of the two
                self.submit(tenant, *args, request_id=rid)
            except Exception as err:  # noqa: BLE001 — isolated
                if self.request_dedup.is_applied(tenant, rid) or self.has_pending_request(rid):
                    # the request IS queued (or already applied) — the raise
                    # was the flush's, i.e. the destination worker's
                    # sickness, not this request's. Parking a queued request
                    # would double-apply it on replay; leave it to the
                    # router's retry and the guard's scoring.
                    continue
                self._parked_requests.append((tenant, args, rid))
                resubmit_failures.append((tenant, err))
        if _bus.enabled():
            payload: Dict[str, Any] = dict(
                source=self.name,
                version=epoch.version,
                workers=epoch.size,
                joined=len(set(epoch.workers) - set(old.workers)),
                left=len(set(old.workers) - set(epoch.workers)),
                moved=len(performed),
                rebalance_bytes=moved_bytes,
            )
            if reason is not None:
                payload["reason"] = reason
            _bus.emit("fleet_epoch", **payload)
        return resubmit_failures

    def _raise_if_failed(self, failures: List[Tuple[Hashable, BaseException]]) -> None:
        if not failures:
            return
        named = ", ".join(f"{t!r} ({type(e).__name__}: {e})" for t, e in failures[:5])
        more = f" (+{len(failures) - 5} more)" if len(failures) > 5 else ""
        raise MetricsUserError(
            f"fleet {self.name!r}: {len(failures)} tenant migration(s) failed —"
            f" {named}{more}. Each failed tenant's state is parked in the"
            " migration ledger and re-admits on its next submit()/compute()/"
            "resize(); no state was lost."
        ) from failures[0][1]

    def _warm_worker(self, worker: Worker, manifest: Optional[Any]) -> None:
        """A joining worker captures its programs before its first apply:
        ``bank.warmup(doc)`` captures each recorded wave program on the live
        bank's leaves (a bank's graphs hold its addresses, so it warms only
        as a live bank). A failed warm costs latency, never the join: it is
        counted in ``stats["warmup_failures"]``."""
        from metrics_tpu_torch import engine as _engine
        from metrics_tpu_torch.obs import warn as _warn

        doc = manifest
        if doc is None and _engine.warmup_report()["recording"]["active"]:
            doc = _engine.manifest_dict()
            if not doc.get("entries"):
                doc = None
        if doc is None:
            return
        try:
            worker.bank.warmup(doc)
        except Exception as err:  # noqa: BLE001 — costs latency, never a join
            self.stats["warmup_failures"] = self.stats.get("warmup_failures", 0) + 1
            _warn.warn_once(
                f"fleet {self.name!r}: warmup of joining worker"
                f" {worker.worker_id!r} failed ({type(err).__name__}: {err});"
                " the worker serves cold (first flush compiles).",
                key=("fleet_warmup_failed", self.name),
            )

    # -- migration engine ----------------------------------------------
    def _killed_by_plan(self, worker_id: Hashable, epoch_version: int) -> bool:
        plan = self._fault_plan
        if plan is None or not isinstance(worker_id, int):
            return False
        return plan.kills(worker_id, epoch_version)

    def _died_by_plan(self, worker_id: Hashable, epoch_version: int) -> bool:
        plan = self._fault_plan
        if plan is None or not isinstance(worker_id, int):
            return False
        return plan.dies(worker_id, epoch_version)

    def _mark_dead(self, worker_id: Hashable, reason: str, forget_memory: bool = False) -> None:
        worker = self._workers.get(worker_id)
        if worker is None or not worker.alive:
            return
        worker.alive = False
        self.stats["kills"] += 1
        if forget_memory:
            # whole-process crash semantics: the bank/router objects are
            # GONE; only the worker's spill store remains readable
            self.stats["dies"] += 1
            worker.forget_memory()
        if _bus.enabled():
            _bus.emit(
                "fleet_epoch",
                source=self.name,
                event="worker_dead",
                worker=str(worker_id),
                reason=reason,
                version=self.epoch.version,
            )

    def _migrate_one(
        self, tenant: Hashable, source: Worker, epoch: FleetEpoch, reason: str
    ) -> Tuple[Hashable, FleetEpoch, int]:
        """Export → publish → re-admit one tenant; the single move sequence
        shared by rebalances and dead-worker recovery. The ledger key is
        remembered in ``_in_flight`` from publish until the admission acks,
        so a failure anywhere leaves the state parked and retryable."""
        payload = source.export_payload(tenant, self._precisions())
        key = _migrate.ledger_key(self.name, epoch.version, tenant)
        self.ledger.publish(key, payload)
        self._in_flight[tenant] = key
        source.stats["migrations_out"] += 1
        source.stats["bytes_out"] += len(payload)
        dst, epoch = self._admit_from_ledger(
            tenant, key, epoch, reason=reason, source=source.worker_id
        )
        return dst, epoch, len(payload)

    def _migrate_moves(
        self, moves: Dict[Hashable, Tuple[Hashable, Hashable]], epoch: FleetEpoch
    ) -> Tuple[
        FleetEpoch,
        Dict[Hashable, Tuple[Hashable, Hashable]],
        int,
        List[Tuple[Hashable, BaseException]],
    ]:
        """Perform ``moves`` toward ``epoch``. Per-tenant failure isolation:
        one tenant's failed move (its state stays parked in the ledger) never
        aborts the rest of the rebalance — the caller commits the epoch and
        raises an aggregate error afterwards. A destination killed by the
        fault plan mid-migration advances the epoch (survivors only) and
        re-routes from the still-published payload."""
        performed: Dict[Hashable, Tuple[Hashable, Hashable]] = {}
        total_bytes = 0
        failures: List[Tuple[Hashable, BaseException]] = []
        for tenant, (src, _dst) in moves.items():
            source = self._workers[src]
            try:
                if tenant not in source.tenants:
                    # known to the fleet, not materialized on this owner —
                    # either never flushed anywhere, or parked in the ledger
                    # by a failed move (the resize in-flight sweep retries it)
                    continue
                dst, epoch, n_bytes = self._migrate_one(tenant, source, epoch, "rebalance")
                performed[tenant] = (src, dst)
                total_bytes += n_bytes
            except Exception as err:  # noqa: BLE001 — isolated, aggregated by the caller
                self.stats["migration_failures"] += 1
                failures.append((tenant, err))
        self.stats["rebalance_bytes"] += total_bytes
        return epoch, performed, total_bytes, failures

    def _admit_from_ledger(
        self,
        tenant: Hashable,
        key: str,
        epoch: FleetEpoch,
        reason: str,
        source: Optional[Hashable] = None,
    ) -> Tuple[Hashable, FleetEpoch]:
        """Admit the ledger payload under ``key`` on the tenant's owner at
        ``epoch``, surviving destination deaths: a dead (or plan-killed)
        owner shrinks the epoch and the next rendezvous owner takes the
        tenant — the payload stays published until an admission acks it."""
        while True:
            if epoch.size == 0:
                # counted by the caller's failure isolation; the in-flight
                # entry keeps the payload retryable
                raise MetricsUserError(
                    f"fleet {self.name!r}: no surviving worker can admit"
                    f" tenant {tenant!r} (payload kept in the ledger under"
                    f" {key!r})."
                )
            dst = _placement.owner(tenant, epoch)
            worker = self._workers[dst]
            if worker.alive and self._died_by_plan(dst, epoch.version):
                self._mark_dead(dst, reason="fault_plan_die", forget_memory=True)
            elif worker.alive and self._killed_by_plan(dst, epoch.version):
                self._mark_dead(dst, reason="fault_plan")
            if not worker.alive:
                epoch = epoch.leave(dst)
                continue
            payload = self.ledger.fetch(key)
            n_bytes = _migrate.admit_payload(
                worker.bank, tenant, payload, context=f" (fleet={self.name!r}, tenant={tenant!r})"
            )
            self.ledger.ack(key)
            self._in_flight.pop(tenant, None)
            worker.stats["migrations_in"] += 1
            worker.stats["bytes_in"] += n_bytes
            self.stats["migrations"] += 1
            if _bus.enabled():
                _bus.emit(
                    "migrate",
                    source=self.name,
                    tenant=str(tenant),
                    src=str(source) if source is not None else None,
                    dst=str(dst),
                    bytes=n_bytes,
                    epoch=epoch.version,
                    reason=reason,
                )
            return dst, epoch

    # ------------------------------------------------------------------
    # failure handling
    # ------------------------------------------------------------------
    def _recover_worker(
        self, worker_id: Hashable, epoch: FleetEpoch
    ) -> Tuple[
        FleetEpoch,
        Dict[Hashable, Tuple[Hashable, Hashable]],
        int,
        List[Tuple[Hashable, Tuple[Any, ...], Any]],
        List[Tuple[Hashable, BaseException]],
    ]:
        """Drain a DEAD worker's state back into the fleet FROM ITS SPILL
        STORE: every acked session's sealed payload is read out of the
        worker's journal+blobs (``serving/store.durable_tenant_payloads`` —
        never the dead bank's Python object, which a real crash would have
        taken with it), published, and re-admitted on the surviving
        rendezvous owners at ``epoch`` (minus the dead worker). Returns the
        evolved epoch, the recovery moves, payload bytes, the dead router's
        un-flushed requests if its memory survived (a ``kill``; the CALLER
        re-submits them after ``self.epoch`` advances — a ``die`` lost
        them), and the per-tenant failures (isolated; each failed tenant's
        payload stays in the store/ledger for a retry, which also keeps the
        worker registered).
        """
        dead = self._workers[worker_id]
        if worker_id in epoch:
            epoch = epoch.leave(worker_id)
        pending = dead.router.drain_pending() if dead.router is not None else []
        # a KILLed worker's memory is still readable: seal its dirty
        # residents' FINAL states into the store before dropping it, so
        # recovery is exact even when the checkpoint cadence was raised
        # (e.g. stretched by an overload brownout) — without this, the
        # store-only read below would lose the acked tail inside the
        # cadence window. A DIEd worker has no memory (forget_memory ran in
        # _mark_dead); its loss window is the documented cadence bound.
        if dead.bank is not None:
            try:
                dead.bank.checkpoint()
                dead.bank.checkpoint()  # second call seals an async-staged batch
            except Exception:  # noqa: BLE001 — poisoned bank: the store is the best left
                pass
        # the store is now the recovery source; the bank object is dead
        # memory — release it so retries can't silently lean on it and a
        # leaked device bank doesn't outlive the worker
        dead.forget_memory()
        # ONE journal replay serves the whole recovery: the payload read, the
        # no-blob sweep, and the deregistration check below all reuse `live`
        live, _torn = _store.replay_journal(dead.store, dead.bank_name)
        payloads = _store.durable_tenant_payloads(dead.store, dead.bank_name, live=live)
        moves: Dict[Hashable, Tuple[Hashable, Hashable]] = {}
        total_bytes = 0
        failures: List[Tuple[Hashable, BaseException]] = []
        for tenant, (payload, _count) in payloads.items():
            try:
                # a tenant an earlier partial recovery already healed onto a
                # live owner (via the in-flight ledger sweep) must not be
                # force-re-imported — just sweep the dead namespace
                if epoch.size:
                    owner = self._workers.get(_placement.owner(tenant, epoch))
                    if (
                        owner is not None
                        and owner.alive
                        and owner.bank is not None
                        and (tenant in owner.bank.tenants or tenant in owner.bank.spilled_tenants)
                    ):
                        _store.journal_drop(dead.store, dead.bank_name, tenant)
                        continue
                if self._migration_precisions is not None:
                    payload = _migrate.reencode_payload(payload, self._precisions())
                key = _migrate.ledger_key(self.name, epoch.version, tenant)
                self.ledger.publish(key, payload)
                self._in_flight[tenant] = key
                dead.stats["migrations_out"] += 1
                dead.stats["bytes_out"] += len(payload)
                dst, epoch = self._admit_from_ledger(
                    tenant, key, epoch, reason="recovery", source=worker_id
                )
                # sweep the dead namespace only after the new owner admitted
                _store.journal_drop(dead.store, dead.bank_name, tenant)
                moves[tenant] = (worker_id, dst)
                total_bytes += len(payload)
                self.stats["recovered_tenants"] += 1
            except Exception as err:  # noqa: BLE001 — isolated, aggregated by the caller
                self.stats["migration_failures"] += 1
                failures.append((tenant, err))
        # journal-live sessions with NO blob: the crash landed between the
        # write-ahead admit record and the defaults-blob put, so the session
        # never had acked state. Sweep them, or the dead namespace never
        # empties and the worker is re-scanned forever; their next request
        # admits them fresh at the registered defaults on the rendezvous
        # owner — the same defaults restore MetricBank.recover performs
        for tenant in live:
            if tenant not in payloads:
                _store.journal_drop(dead.store, dead.bank_name, tenant)
        self.stats["rebalance_bytes"] += total_bytes
        # every session left the namespace: admitted elsewhere, or swept
        # (only a per-tenant failure keeps its payload parked for retry) —
        # so clear the journal too: die/recover/join cycles would otherwise
        # grow the namespace's drop records without bound, and a rejoining
        # worker id should start from an empty log
        if not failures:
            dead.store.rewrite_journal(dead.bank_name, [])
            self._workers.pop(worker_id, None)
        return epoch, moves, total_bytes, pending, failures

    def _recover_all_dead(
        self, epoch: FleetEpoch
    ) -> Tuple[
        FleetEpoch,
        Dict[Hashable, Tuple[Hashable, Hashable]],
        int,
        List[Tuple[Hashable, Tuple[Any, ...], Any]],
        List[Tuple[Hashable, BaseException]],
    ]:
        """Recover EVERY dead worker still registered, re-scanning until none
        remain — a destination cascade-killed by the fault plan *during* a
        recovery is itself recovered, not orphaned with its tenants' state
        stranded in its dead bank. Each dead worker is attempted once per
        call (a partially-unrecoverable one stays registered for a retry)."""
        moves: Dict[Hashable, Tuple[Hashable, Hashable]] = {}
        total_bytes = 0
        pending: List[Tuple[Hashable, Tuple[Any, ...], Any]] = []
        failures: List[Tuple[Hashable, BaseException]] = []
        attempted: set = set()
        while True:
            dead = [
                w for w, wk in self._workers.items() if not wk.alive and w not in attempted
            ]
            if not dead:
                return epoch, moves, total_bytes, pending, failures
            attempted.add(dead[0])
            epoch, recovered, bytes_rec, reqs, fails = self._recover_worker(dead[0], epoch)
            moves.update(recovered)
            total_bytes += bytes_rec
            pending.extend(reqs)
            failures += fails

    def kill(self, worker_id: Hashable) -> Dict[Hashable, Tuple[Hashable, Hashable]]:
        """Ungraceful worker loss: no drain, no cooperation. Recovery reads
        every acked session's payload FROM THE WORKER'S SPILL STORE (its
        journal + sealed blobs — with the fleet's default checkpoint cadence
        of 1 that is bit-identical to the last applied request), publishes
        each payload, re-admits on the surviving rendezvous owners, and
        re-submits the dead router's un-flushed requests — the stream is
        applied exactly once. Returns ``{tenant: (dead_worker, new_owner)}``.
        """
        return self._fell(worker_id, die=False)

    def die(self, worker_id: Hashable) -> Dict[Hashable, Tuple[Hashable, Hashable]]:
        """Whole-process crash: like :meth:`kill`, but the worker's bank AND
        router objects are gone before recovery starts — no graceful export,
        no un-flushed-request re-submission; the durable tier is the ONLY
        recovery source. Acked (checkpointed) state restores bit-identically;
        requests the worker accepted but never checkpointed are lost — the
        durability window ``checkpoint_every_n_flushes`` bounds. Returns
        ``{tenant: (dead_worker, new_owner)}``."""
        return self._fell(worker_id, die=True)

    def _fell(self, worker_id: Hashable, die: bool) -> Dict[Hashable, Tuple[Hashable, Hashable]]:
        with self._lock:
            if worker_id not in self._workers:
                raise KeyError(f"unknown worker {worker_id!r} in fleet {self.name!r}")
            old = self.epoch
            self._mark_dead(worker_id, reason="die" if die else "kill", forget_memory=die)
            # _recover_all_dead: a destination the fault plan fells DURING
            # this recovery is recovered in turn, never orphaned
            epoch, moves, total_bytes, pending, failures = self._recover_all_dead(self.epoch)
            failures += self._commit_epoch(
                old, epoch, moves, total_bytes, pending, reason="die" if die else "kill"
            )
            self._raise_if_failed(failures)
            return moves

    # ------------------------------------------------------------------
    # ops surface
    # ------------------------------------------------------------------
    def pending_detail(self) -> Dict[Hashable, Dict[str, Any]]:
        """Per-worker, per-signature pending/starvation view (each worker
        router's ``pending_detail()`` keyed by worker id)."""
        with self._lock:
            return {
                wid: w.router.pending_detail() for wid, w in self._workers.items() if w.alive
            }

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "template": type(self._template).__name__,
                "epoch": self.epoch.version,
                "workers": {str(wid): w.summary() for wid, w in self._workers.items()},
                "tenants": len(self._tenants),
                "capacity": self.capacity,
                # the park-and-retry state, surfaced: tenants whose
                # state sits in the migration ledger awaiting re-admission,
                # and requests whose post-recovery resubmission failed —
                # both invisible until the next resize unless watched here
                "in_flight_tenants": len(self._in_flight),
                "parked_requests": len(self._parked_requests),
                "dedup": self.request_dedup.summary(),
                **self.stats,
            }

    def __repr__(self) -> str:
        return (
            f"Fleet(name={self.name!r}, epoch=v{self.epoch.version},"
            f" workers={len(self._workers)}, tenants={len(self._tenants)})"
        )


class FleetRouter:
    """The request-plane face of a :class:`Fleet` — rendezvous-routed
    ``submit``/``poll``/``flush`` wrapping each worker's
    :class:`~metrics_tpu_torch.serving.RequestRouter`, plus the coordination-free
    ``owner_of(tenant, epoch)`` any peer answers locally."""

    def __init__(self, fleet: Fleet) -> None:
        self.fleet = fleet

    def owner_of(self, tenant: Hashable, epoch: Optional[FleetEpoch] = None) -> Hashable:
        return self.fleet.owner_of(tenant, epoch)

    def submit(self, tenant: Hashable, *args: Any) -> int:
        return self.fleet.submit(tenant, *args)

    def poll(self) -> int:
        return self.fleet.poll()

    def flush(self) -> int:
        return self.fleet.flush()

    @property
    def pending(self) -> int:
        return self.fleet.pending_requests()

    def pending_detail(self) -> Dict[Hashable, Dict[str, Any]]:
        return self.fleet.pending_detail()

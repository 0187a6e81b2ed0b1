"""Multi-tenant metric state banks: many sessions, one program per wave
(counterpart of ``metrics_tpu/serving/bank.py``).

A :class:`MetricBank` holds the states of up to ``capacity`` sessions of one
metric configuration (or one fusable ``MetricCollection``) as one set of
device tensors with a leading tenant axis (``[capacity, ...]`` per state).
A wave of ``(tenant, update args)`` requests runs as one program of the
engine (``engine/cache.bank_entry``): a CUDA graph on the card, replayed
for every later wave of the same signature, and the eager transition on
the CPU. Each request runs the same ``resilience/health.traced_update`` a
solo instance runs (``on_bad_input="skip"``/``"mask"`` screening, the
health counters and the pow2 pad correction included), so a tenant's state
is bit-identical to a solo instance fed the same requests.

**The bank is written in place.** The JAX package donates the bank to each
wave's program; a CUDA graph reads and writes fixed addresses instead. The
bank's leaves are therefore *resident*: fixed tensors (``capacity + 1``
rows, the last a sink row that pad requests address and no tenant owns)
that the programs read and write in place. Only the slot ids and the
requests' inputs are copied into a program. This is a deliberate exception
to the engine's rule that states are replaced, never written in place, so
everything that hands a row to a caller takes a copy of it:
:meth:`MetricBank.tenant_state`, the exports, the checkpoint gather, an
audit's pre and post capture and :meth:`MetricBank.compute_async`; a later
wave never changes such a snapshot. A wave writes its new rows back only
after every request's transition has run, and the warm-up ahead of a
wave's capture writes none (they go in once the capture is taken), so a
wave that raises or whose capture is refused leaves the bank as it was (on
the CPU as on the card); the bank is never lost, where the JAX bank can be
poisoned by a failed donated dispatch. The captured waves are the bank's
own (``engine/cache.Resident``) and are freed with it.

Sessions beyond ``capacity`` spill: admission evicts the least-recently
used tenant and seals its state through the checkpoint encode
(``utils/checkpoint.metric_state_pytree``) into the bank's
:class:`~metrics_tpu_torch.serving.SpillStore`; re-admission decodes it
exactly. Every admission, spill, checkpoint, import and drop is journaled
write-ahead into the store (``serving/store.py``), so :meth:`MetricBank.recover`
rebuilds every acknowledged session after the process died; the payloads
and records are the JAX package's bytes. ``audit_rate=`` samples flushes
for shadow replay (``resilience/integrity.IntegrityAuditor``).

**Pod-scale banks** (``mesh=``, ``tenant_axis=``): the bank is laid out over
a ``torch.distributed`` ``DeviceMesh`` with one process per device, and is
SPMD: every process of the mesh builds it with the same arguments and
makes the same calls in the same order (``serving/pod.py``). Each process
keeps the whole host bookkeeping and holds only its rows: tenant shard
``s`` owns the slots ``[s * shard_capacity, (s + 1) * shard_capacity)``,
and a member state registered with ``add_state(sharding=)`` (a
``class_sharding="mp"`` confusion matrix) keeps its ``torch.chunk`` slice
over its own axis, updated by the class-windowed kernels. A wave runs on
each process only the requests it owns, in its captured program (no
collective in it), and commits only where every process's part succeeded
(one small all-reduce). The reads (:meth:`MetricBank.compute`,
:meth:`~MetricBank.compute_many`, :meth:`~MetricBank.compute_async`,
:meth:`~MetricBank.tenant_state`, :meth:`~MetricBank.materialize`, the
exports, the checkpoint, spill and audit gathers, and :meth:`~MetricBank.summary`'s
health totals, so ``obs.snapshot()`` too) are collectives: the owners'
rows cross the mesh in one exchange per call, and every process gets the
same global rows. Mesh rank 0 alone reads and writes the store, with the
JAX package's bytes. Without a mesh a template's ``add_state(sharding=)``
annotations are inert configuration here as in the JAX package; they
travel with spills and exports.

**Warm starts.** :meth:`MetricBank.warmup` makes the wave and epoch
programs a warmup manifest recorded (``engine/warmup.py``) on this bank's
leaves before its first wave.

Observability: ``admit``/``evict``/``flush``/``journal``/``spill_write``/
``recover``/``repair``/``bank_drive`` events, and the per-bank gauges of
:func:`serving_summary` (``obs.snapshot()["serving"]``, the
``metrics_tpu_bank_*`` families).
"""
import itertools
import threading
import time
import weakref
from typing import Any, Dict, Hashable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from metrics_tpu_torch.engine import _tree
from metrics_tpu_torch.engine import bucketing as _bucketing
from metrics_tpu_torch.engine import cache as _cache
from metrics_tpu_torch.obs import bus as _bus
from metrics_tpu_torch.obs import trace as _trace
from metrics_tpu_torch.resilience import health as _health
from metrics_tpu_torch.resilience import integrity as _integrity
from metrics_tpu_torch.serving import pod as _pod
from metrics_tpu_torch.serving import store as _spill
from metrics_tpu_torch.sharding import spec as _shard_spec
from metrics_tpu_torch.utils.exceptions import MetricsUserError, StateIntegrityError

__all__ = ["MetricBank", "all_banks", "serving_summary"]

# live banks, for obs.snapshot and the Prometheus dump; weak, so a dropped
# bank does not leak its tensors through telemetry
_BANKS: "weakref.WeakSet[MetricBank]" = weakref.WeakSet()
_BANK_IDS = itertools.count()
_REGISTRY_LOCK = threading.Lock()


class _Wave:
    """One wave as :meth:`MetricBank._apply_batch_locked`'s phases hand it on."""

    __slots__ = (
        "requests", "claimed", "tenants", "leaves_per_req", "spec", "pads", "entry", "stats", "slots", "audit",
        "n_req", "dense", "n_launches", "staged", "err",
    )

    def __init__(self) -> None:
        self.audit: Optional[Tuple] = None
        self.staged: Any = None
        self.err: Optional[BaseException] = None


def all_banks() -> List["MetricBank"]:
    with _REGISTRY_LOCK:
        return sorted(_BANKS, key=lambda b: b.name)


def serving_summary() -> Dict[str, Any]:
    """``{bank name: bank.summary()}`` for every live bank: the serving
    section of ``obs.snapshot()`` and the source of the ``metrics_tpu_bank_*``
    Prometheus families."""
    return {bank.name: bank.summary() for bank in all_banks()}


def _bankable_error(template: Any) -> Optional[str]:
    """Why this template cannot ride a bank, or None (the JAX package's rules:
    the bank program is the same transition a solo program runs)."""
    if not template._enable_jit or template._jit_failed:
        return "its update is not jit-compiled (jit_update=False or a prior trace failure)"
    if template._has_list_state():
        return "it holds list states (unbounded per-tenant buffers cannot share a fixed-shape bank)"
    if getattr(template, "on_bad_input", "propagate") == "raise":
        return "on_bad_input='raise' needs a per-update host check, incompatible with batched dispatch"
    if _health.health_enabled(template) and _health.forces_eager(template):
        return "its health policy forces eager dispatch (warn-on-removal or non-additive mask)"
    if template._shape_polymorphic_states:
        return (
            "its update reassigns state shapes"
            f" ({sorted(template._shape_polymorphic_states)}), which a fixed-shape"
            " slot bank cannot hold"
        )
    return None


def _host_tensor(x: Any) -> Any:
    """A request leaf as the program takes it: numpy becomes a tensor."""
    return torch.as_tensor(x) if isinstance(x, np.ndarray) else x


def _index(rows: Sequence[int], device: torch.device) -> torch.Tensor:
    """Row indices on ``device``: on the card from pinned memory, copied
    without a host sync (the allocator keeps the block until the copy ran)."""
    idx = torch.tensor(list(rows), dtype=torch.int64)
    if device.type != "cuda":
        return idx
    return idx.pin_memory().to(device, non_blocking=True)


def _sig_of(leaf: Any) -> Tuple:
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), leaf.dtype)
    return ((), type(leaf).__name__)


class MetricBank:
    """Device-resident state bank serving up to ``capacity`` sessions of one
    metric configuration, with one program per wave and LRU spill.

    Args:
        template: a configured :class:`~metrics_tpu_torch.Metric`; the bank
            clones it, and every tenant behaves as a private clone of it. A
            :class:`~metrics_tpu_torch.MetricCollection` whose every member
            fuses is also accepted (a *collection bank*): each member's
            states live in the tenant's row under ``"member::state"`` names
            and one wave runs every member.
        capacity: device-resident tenant slots. Sessions beyond it are
            admitted by spilling the least-recently-used tenant.
        name: label for telemetry and the bank's namespace in the store
            (default ``bank<N>``); a bank that should recover across
            restarts needs a stable name.
        dense_threshold: fraction of ``capacity`` from which a wave counts
            as ``dense`` (the JAX package's variant choice, kept in the stats
            and the ``flush`` events; every wave runs one program here, its
            requests alone).
        spill_store: where spilled tenants and the journal live (default: a
            private :class:`~metrics_tpu_torch.serving.MemoryStore`; a
            :class:`~metrics_tpu_torch.serving.DiskStore` survives the
            process).
        checkpoint_every_n_flushes: every N applied waves, each dirty
            resident tenant's state is sealed into the store (one coalesced
            copy to the host). None: only spills, imports and exports write.
        checkpoint_async: stage each periodic checkpoint's copy
            (:class:`~metrics_tpu_torch.engine.AsyncResult`) and seal it one
            boundary later; a :meth:`checkpoint` call with nothing dirty
            seals the staged batch at once.
        request_dedup: a shared :class:`~metrics_tpu_torch.serving.RequestDedup`
            for exactly-once apply of requests tagged with a ``request_id``.
        audit_rate: fraction of flushes shadow-audited (None: no audits).
        mesh: a ``DeviceMesh`` with named dims, one process per device, that
            the bank is laid out over (see the module docstring): the
            members' states registered with ``add_state(sharding=)`` are
            split over their axes. Every process of the mesh builds the
            bank and makes the same calls.
        tenant_axis: a mesh axis (or a tuple of axes) the tenant slots are
            split over: ``capacity`` then counts slots per shard, so
            :attr:`capacity` is ``capacity * n_shards`` and
            :attr:`shard_capacity` is ``capacity``; admission fills the
            emptiest shard. Needs ``mesh``, and may share no axis with a
            state's sharding.

    ``update(tenant, *args)`` is a one-request :meth:`apply_batch`; serving
    traffic goes through a :class:`~metrics_tpu_torch.serving.RequestRouter`.
    """

    def __init__(
        self,
        template: Any,
        capacity: int,
        *,
        name: Optional[str] = None,
        dense_threshold: float = 0.5,
        spill_store: Optional[_spill.SpillStore] = None,
        checkpoint_every_n_flushes: Optional[int] = None,
        checkpoint_async: bool = False,
        request_dedup: Optional[Any] = None,
        audit_rate: Optional[float] = None,
        mesh: Optional[Any] = None,
        tenant_axis: Optional[Any] = None,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if checkpoint_every_n_flushes is not None and checkpoint_every_n_flushes < 1:
            raise ValueError(
                f"checkpoint_every_n_flushes must be >= 1 (or None), got {checkpoint_every_n_flushes}"
            )
        if audit_rate is not None and not 0.0 < audit_rate <= 1.0:
            raise ValueError(f"audit_rate must be in (0, 1] (or None), got {audit_rate}")
        # -- pod-scale layout (mesh / tenant_axis) -------------------------
        if tenant_axis is not None and mesh is None:
            raise MetricsUserError(
                "MetricBank(tenant_axis=) needs mesh= too — the tenant axis names a mesh axis the leading"
                " tenant dimension is laid out over."
            )
        self._mesh = mesh
        self._tenant_axes: Tuple[str, ...] = ()
        n_shards = 1
        if tenant_axis is not None:
            axes = (tenant_axis,) if isinstance(tenant_axis, str) else tuple(tenant_axis)
            mesh_axes = _shard_spec.axis_names(mesh)
            for ax in axes:
                if ax not in mesh_axes:
                    raise MetricsUserError(f"tenant_axis {ax!r} is not an axis of the mesh (axes: {mesh_axes}).")
            self._tenant_axes = axes
            for ax in axes:
                n_shards *= _shard_spec.axis_size(mesh, ax)
        self._n_shards = n_shards

        from metrics_tpu_torch.collections import MetricCollection

        self._is_collection = isinstance(template, MetricCollection)
        if self._is_collection:
            if audit_rate is not None:
                raise MetricsUserError(
                    "collection banks do not support audit_rate: the shadow-replay auditor replays solo Metric clones."
                )
            all_keys = tuple(template._modules.keys())
            if any("::" in k for k in all_keys):
                raise MetricsUserError(
                    "collection bank member keys may not contain '::' — it is the bank's leaf-name separator."
                )
            fusable = set(template._fusable_keys())
            stragglers = [k for k in all_keys if k not in fusable]
            if stragglers:
                raise MetricsUserError(
                    "a collection bank needs EVERY member on the fused-update"
                    f" path; these members cannot fuse: {stragglers}."
                    " Serve them from their own banks (or solo)."
                )
            for k in all_keys:
                reason = _bankable_error(template._modules[k])
                if reason is not None:
                    raise MetricsUserError(f"collection member {k!r} cannot ride a bank: {reason}.")
            self._template = template.clone()
            self._member_keys: Tuple[str, ...] = tuple(self._template._modules.keys())
            self._members: List[Any] = [self._template._modules[k] for k in self._member_keys]
            defaults = {
                f"{k}::{n}": m._defaults[n] for k, m in zip(self._member_keys, self._members) for n in m._defaults
            }
            self._reductions_ns = {
                f"{k}::{n}": m._reductions[n] for k, m in zip(self._member_keys, self._members) for n in m._defaults
            }
            # the router folds this into its signature: one wave per
            # collection bank, not one per member
            self._signature_token: Optional[Tuple] = (
                "collection",
                self._member_keys,
                tuple(_cache.metric_fingerprint(m)[0] for m in self._members),
            )
        else:
            reason = _bankable_error(template)
            if reason is not None:
                raise MetricsUserError(
                    f"{type(template).__name__} cannot be served from a MetricBank: {reason}."
                    " Serve such metrics as solo instances."
                )
            self._template = template.clone()
            self._member_keys = ()
            self._members = [self._template]
            defaults = dict(self._template._defaults)
            self._reductions_ns = dict(self._template._reductions)
            self._signature_token = None

        # -- per-leaf layout: the tenant axes, then each state's own split --
        shard_specs: Dict[str, Any] = {}
        for k, m in zip(self._member_keys or ("",), self._members):
            for n, spec in (m.__dict__.get("_state_shardings") or {}).items():
                if _shard_spec.canonical_spec(spec):
                    shard_specs[f"{k}::{n}" if self._is_collection else n] = spec
        if mesh is None:
            # without a mesh the annotations are inert configuration (they
            # still travel with spills and exports)
            shard_specs = {}
        # the mesh axes each split state is split over
        self._state_axes: Dict[str, set] = {}
        for n, spec in shard_specs.items():
            used = {a for e in tuple(spec) if e for a in ((e,) if isinstance(e, str) else tuple(e))}
            self._state_axes[n] = used
            if used & set(self._tenant_axes):
                raise MetricsUserError(
                    f"state {n!r} shards over {sorted(used & set(self._tenant_axes))}, which is the bank's"
                    " tenant_axis — a state axis and the tenant axis cannot share mesh axes."
                )
        self.shard_capacity = int(capacity)
        self.capacity = int(capacity) * n_shards
        self.name = name if name is not None else f"bank{next(_BANK_IDS)}"
        self.dense_threshold = float(dense_threshold)
        self._device = self._members[0].device
        self._defaults = defaults
        # the programs run on members placed on the mesh (each process's
        # slices of the split states, their defaults too); the template and
        # its members stay global for the host side: encode, decode, compute
        self._cell_template = self._template
        if shard_specs:
            self._cell_template = self._template.clone()
            placed = self._cell_template._modules.values() if self._is_collection else [self._cell_template]
            for m in placed:
                if m.__dict__.get("_state_shardings"):
                    m.shard_states(mesh)
        self._cell_members: List[Any] = (
            [self._cell_template._modules[k] for k in self._member_keys] if self._is_collection else [self._cell_template]
        )
        local_defaults = {
            (f"{k}::{n}" if self._is_collection else n): m._defaults[n]
            for k, m in zip(self._member_keys or ("",), self._cell_members)
            for n in m._defaults
        }
        self._pod: Optional[_pod.PodLayout] = None
        if mesh is not None:
            self._pod = _pod.PodLayout(
                mesh,
                self._tenant_axes,
                self.shard_capacity,
                {n: (shard_specs.get(n), tuple(d.shape)) for n, d in defaults.items()},
            )
        # whether the attributes a member learns in its first update
        # (``_dynamic_state_attrs``: ``Accuracy.mode``) reached every process
        self._init_shared = mesh is None
        # the tenants the last admission batch journaled fresh
        self._fresh: List[Hashable] = []
        # the resident leaves (this process's rows: the shard's, or all of
        # them without tenant shards), a sink row past them, with the
        # programs captured over them; ``_bank`` views the tenants' rows
        self._resident = _cache.Resident(
            {
                n: d.unsqueeze(0).expand((self.shard_capacity + 1,) + tuple(d.shape)).contiguous()
                for n, d in local_defaults.items()
            },
            layout=(self._tenant_axes, n_shards, self._pod.shard if self._pod is not None else 0),
        )
        self._bank: Dict[str, torch.Tensor] = {n: leaf[: self.shard_capacity] for n, leaf in self._resident.items()}
        self._slots: Dict[Hashable, int] = {}
        self._counts: Dict[Hashable, int] = {}
        self._lru: Dict[Hashable, int] = {}
        # per-shard free lists: shard s owns the contiguous slots
        # [s * shard_capacity, (s + 1) * shard_capacity); pop() -> the
        # shard's lowest slot first
        self._free_by_shard: List[List[int]] = [
            list(range((s + 1) * self.shard_capacity - 1, s * self.shard_capacity - 1, -1)) for s in range(n_shards)
        ]
        # tenant -> blob key of a spilled session (the payload is in the store)
        self._spilled: Dict[Hashable, str] = {}
        # last durable update count, health counters and digests per
        # journaled session (what recovery restores; the compaction source)
        self._durable_counts: Dict[Hashable, int] = {}
        self._durable_health: Dict[Hashable, Optional[List[int]]] = {}
        self._durable_digest: Dict[Hashable, Optional[Dict[str, str]]] = {}
        # per-session generation, minted at fresh admit/import/recover: an
        # async-staged checkpoint seals only if its session is still the
        # live one (a dropped and re-admitted tenant restarts its count)
        self._gen: Dict[Hashable, int] = {}
        self._gen_next = 0
        # health counters of the spilled tenants, so the bank-wide rate
        # does not drop under LRU churn
        self._spilled_health = np.zeros(_health.N_SLOTS, dtype=np.int64)
        self._store = spill_store if spill_store is not None else _spill.MemoryStore()
        self._ckpt_every = checkpoint_every_n_flushes
        self._ckpt_async = bool(checkpoint_async)
        self._pending_ckpt: Optional[Tuple[Any, List[Tuple[Hashable, int, Optional[int]]]]] = None
        self._flushes_since_ckpt = 0
        self._dirty: Dict[Hashable, None] = {}
        # existing records count too (a reused namespace starts with history)
        self._journal_len = self._store_read(lambda: len(self._store.journal_frames(self.name)))
        self._defaults_payload: Optional[bytes] = None
        self._tick = 0
        self._lock = threading.RLock()
        self._dedup = request_dedup
        self._flush_ms_ewma: Optional[float] = None
        self._last_flush_ms: Optional[float] = None
        # gray-fault hook: called with no args at the top of every apply,
        # before any state is touched
        self.fault_injector: Optional[Any] = None
        # silent-corruption hook: called with the wave's tenants at the end
        # of every applied flush, after the cadence checkpoint sealed clean
        # state and before the audit's post capture
        self.state_fault_injector: Optional[Any] = None
        self.audit_rate = audit_rate
        self._audit_period = None if audit_rate is None else max(1, int(round(1.0 / audit_rate)))
        self._flush_index = 0
        self._audit_cursor = 0
        self._pending_audits: List[Any] = []
        self.stats: Dict[str, int] = {
            "admits": 0,
            "readmits": 0,
            "evictions": 0,
            "spills": 0,
            "launches": 0,
            "requests": 0,
            "scatter_launches": 0,
            "dense_launches": 0,
            "bucketed_requests": 0,
            "lost_tenants": 0,
            "exports": 0,
            "imports": 0,
            "checkpoints": 0,
            "journal_appends": 0,
            "flush_errors": 0,
            "dedup_dropped": 0,
            "audits_sampled": 0,
            "repairs": 0,
            "bank_drives": 0,
            "drive_steps": 0,
            "coalesced_gathers": 0,
        }
        # key the cells now, as unlearned: a tenant imported or readmitted
        # before the first wave teaches them what a first update learns
        # (``Accuracy.mode``), and a cell keyed after that would serve
        # another entry than its peers' and its warmup manifest's
        for m in self._cell_members:
            _cache.metric_fingerprint(m)
        with _REGISTRY_LOCK:
            _BANKS.add(self)

    @property
    def store(self) -> _spill.SpillStore:
        """The bank's spill store (the durable tier when persistent)."""
        return self._store

    # ------------------------------------------------------------------
    # admission / eviction
    # ------------------------------------------------------------------
    @property
    def occupancy(self) -> int:
        with self._lock:
            return len(self._slots)

    @property
    def tenants(self) -> List[Hashable]:
        with self._lock:
            return list(self._slots)

    @property
    def spilled_tenants(self) -> List[Hashable]:
        with self._lock:
            return list(self._spilled)

    def _touch(self, tenant: Hashable) -> None:
        self._tick += 1
        self._lru[tenant] = self._tick

    def _slot_shard(self, slot: int) -> int:
        return slot // self.shard_capacity

    def _pick_shard(self) -> int:
        """Admission routing: the emptiest tenant shard (most free slots),
        lowest shard index on ties, so per-shard occupancy stays within one."""
        return max(range(self._n_shards), key=lambda s: (len(self._free_by_shard[s]), -s))

    def _release_slot(self, slot: int) -> None:
        self._free_by_shard[self._slot_shard(slot)].append(slot)

    def _owns(self, slot: int) -> bool:
        """Whether this process holds the slot's row (always, off a mesh)."""
        return self._pod is None or self._pod.owns(slot)

    def _local_row(self, slot: int) -> int:
        return slot if self._pod is None else self._pod.local_row(slot)

    def _cell(self) -> Any:
        """What the bank programs bind as their cell: the (placed) member
        list of a collection bank, the (placed) template metric otherwise."""
        return self._cell_members if self._is_collection else self._cell_template

    def _entry(self) -> Any:
        if self._is_collection:
            return _cache.collection_bank_entry(self._member_keys, self._cell_members, layout=self._resident.layout)
        return _cache.bank_entry(self._cell_template, layout=self._resident.layout)

    def _snapshot_templates(self) -> List[Dict[str, Any]]:
        return [m._snapshot_state() for m in self._cell_members]

    def _restore_templates(self, saved: List[Dict[str, Any]]) -> None:
        for m, s in zip(self._cell_members, saved):
            m._restore_state(s)

    # -- the store: mesh rank 0 alone reads and writes it ------------------
    def _store_read(self, fn: Any) -> Any:
        """``fn()`` (a store read): here, or on a pod bank run by mesh rank 0
        and its result (or error) handed to every process."""
        return fn() if self._pod is None else self._pod.from_writer(fn)

    def _store_write(self, fn: Any) -> None:
        """``fn()`` (a store write): here, or on a pod bank by mesh rank 0
        alone, then one agreement: its error raises on every process right
        there, so every process's bookkeeping stops where the store did, as
        it does off a mesh."""
        if self._pod is None:
            fn()
            return
        err: Optional[BaseException] = None
        if self._pod.writer:
            try:
                fn()
            except Exception as e:
                err = e
        self._pod.agree(err)

    def _bucketing_active(self, batched: Tuple[int, ...]) -> bool:
        """Whether ragged request batches may pow2-pad: every member opted in."""
        return bool(batched) and all(_bucketing.bucketing_active(m, batched) for m in self._members)

    def _nest(self, flat: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
        return _cache.nest_member_states(self._member_keys, flat)

    def signature_token(self) -> Optional[Tuple]:
        """A collection bank's fused signature (member keys and fingerprints),
        which the router folds into its grouping; None for a metric bank."""
        return self._signature_token

    def admit(self, tenant: Hashable) -> int:
        """Make ``tenant`` device-resident; returns its slot. A new tenant
        starts at the registered defaults, a spilled one is decoded exactly;
        a full bank spills its least-recently-used tenant first. Emits an
        ``admit`` event."""
        with self._lock:
            return self._admit_many([tenant])[0]

    def _admit_many(self, tenants: List[Hashable]) -> List[int]:
        """Admit a batch; its tenants are pinned against each other's
        evictions (the caller holds the lock). On a pod bank the spilled
        ones' blobs come from mesh rank 0 in one broadcast. A tenant's slot
        is taken only once its store writes succeeded, and the rows of the
        tenants admitted before a failure are written all the same, so a
        failed store write leaves no slot whose row is not its tenant's."""
        pinned = frozenset(tenants)
        writes: Dict[int, Dict[str, Any]] = {}
        slots: List[int] = []
        self._fresh = []
        blobs = self._read_blobs([t for t in tenants if t not in self._slots and t in self._spilled])
        try:
            for tenant in tenants:
                if tenant in self._slots:
                    self._touch(tenant)
                    slots.append(self._slots[tenant])
                    continue
                readmit = tenant in self._spilled
                if not any(self._free_by_shard):
                    self._evict_lru(pinned)
                shard = self._pick_shard()
                if readmit:
                    state, count = self._decode_spilled(tenant, blobs.get(tenant))
                    # resident again; the blob stays as the durable watermark
                    self._unindex_spilled(tenant)
                    self.stats["readmits"] += 1
                else:
                    # write-ahead: the session exists durably (record + defaults
                    # blob) before any device state is touched
                    self._journal("admit", tenant)
                    key = self._blob_key(tenant)
                    self._store_write(lambda: self._store.put(key, self._defaults_sealed()))
                    self._durable_counts[tenant] = 0
                    self._durable_health[tenant] = None
                    self._durable_digest[tenant] = None
                    self._fresh.append(tenant)
                    self._gen[tenant] = self._gen_next
                    self._gen_next += 1
                    state, count = self._defaults, 0
                    self.stats["admits"] += 1
                slot = self._free_by_shard[shard].pop()
                writes[slot] = state
                self._counts[tenant] = count
                self._slots[tenant] = slot
                self._touch(tenant)
                slots.append(slot)
                if _bus.enabled():
                    _bus.emit(
                        "admit",
                        source=type(self._template).__name__,
                        bank=self.name,
                        tenant=str(tenant),
                        slot=slot,
                        readmit=readmit,
                        occupancy=len(self._slots),
                    )
        finally:
            if writes:
                self._write_slots(writes)
        self._maybe_compact_journal()
        return slots

    def _evict_lru(self, pinned: frozenset) -> None:
        victims = [t for t in self._slots if t not in pinned]
        if not victims:
            raise MetricsUserError(
                f"MetricBank {self.name!r} cannot admit: every resident tenant"
                " is part of the current batch (batch size exceeds capacity"
                f" {self.capacity}). Route through a RequestRouter with"
                " max_requests <= capacity."
            )
        self._evict_locked(min(victims, key=lambda t: self._lru[t]))

    def evict(self, tenant: Hashable, spill: bool = True) -> None:
        """Remove ``tenant``: ``spill=True`` seals its state into the store
        for exact re-admission, ``spill=False`` drops the session (journaled,
        blob deleted). Emits an ``evict`` event."""
        with self._lock:
            self._evict_locked(tenant, spill)

    def _evict_locked(self, tenant: Hashable, spill: bool = True) -> None:
        if not spill and tenant in self._spilled:
            self._drop_spilled_entry(tenant, op="drop")
            return
        if tenant not in self._slots:
            raise KeyError(f"tenant {tenant!r} is not resident in bank {self.name!r}")
        slot, count = self._slots[tenant], self._counts[tenant]
        # the store first: a failed write leaves the session resident
        if spill:
            tree = self._encode_state(self._fetch_rows([slot])[0], count)
            self._write_tenant_blob(tenant, tree, count, op="spill")
        else:
            self._journal("drop", tenant)
            key = self._blob_key(tenant)
            self._store_write(lambda: self._store.delete(key))
        del self._slots[tenant], self._counts[tenant]
        self._lru.pop(tenant, None)
        self._dirty.pop(tenant, None)
        if spill:
            self._index_spilled(tenant)
            self.stats["spills"] += 1
        else:
            self._forget_durable(tenant)
        self._release_slot(slot)
        self.stats["evictions"] += 1
        self._maybe_compact_journal()
        if _bus.enabled():
            _bus.emit(
                "evict",
                source=type(self._template).__name__,
                bank=self.name,
                tenant=str(tenant),
                slot=slot,
                spilled=spill,
                occupancy=len(self._slots),
            )

    def _forget_durable(self, tenant: Hashable) -> None:
        self._durable_counts.pop(tenant, None)
        self._durable_health.pop(tenant, None)
        self._durable_digest.pop(tenant, None)
        self._gen.pop(tenant, None)

    def _drop_spilled_entry(self, tenant: Hashable, op: str = "drop") -> None:
        """Forget a spilled session: journal it, delete its blob, unwind the
        health aggregate."""
        self._journal(op, tenant)
        key = self._spilled[tenant]
        self._store_write(lambda: self._store.delete(key))
        self._unindex_spilled(tenant)
        self._forget_durable(tenant)
        self._maybe_compact_journal()

    # ------------------------------------------------------------------
    # durable plane: journal and sealed blobs in the store
    # ------------------------------------------------------------------
    def _journal(self, op: str, tenant: Hashable, **extra: Any) -> None:
        record = _spill.seal_record({"op": op, "t": _spill.durable_token(tenant), **extra})
        self._journal_many([(op, tenant, record)])

    def _journal_many(self, entries: List[Tuple[str, Hashable, bytes]]) -> None:
        """Append sealed records in one store write."""
        if not entries:
            return
        records = [record for _op, _tenant, record in entries]
        self._store_write(lambda: self._store.append_journal_many(self.name, records))
        self._journal_len += len(records)
        self.stats["journal_appends"] += len(records)
        _spill.bump("journal_appends", len(records))
        _spill.bump("journal_bytes", sum(len(r) for r in records))
        if _bus.enabled():
            for op, tenant, _record in entries:
                _bus.emit("journal", source=type(self._template).__name__, bank=self.name, op=op, tenant=str(tenant))

    def _blob_key(self, tenant: Hashable) -> str:
        return _spill.tenant_blob_key(self.name, _spill.durable_token(tenant))

    def _defaults_sealed(self) -> bytes:
        if self._defaults_payload is None:
            # stored payloads are always exact: a sync quantization tag
            # would bake its rounding into the state across spill churn
            self._defaults_payload = _spill.encode_tenant_payload(self._encode_state(self._defaults, 0))
        return self._defaults_payload

    @staticmethod
    def _health_list(tree: Dict[str, Any]) -> Optional[List[int]]:
        if _health.HEALTH_STATE not in tree:
            return None
        return [int(x) for x in np.asarray(tree[_health.HEALTH_STATE]).ravel()]

    def _write_tenant_blob(
        self, tenant: Hashable, tree: Dict[str, Any], count: int, op: str, defer_journal: bool = False
    ) -> Optional[Tuple[str, Hashable, bytes]]:
        """Seal one tenant's checkpoint tree into the store and journal it
        (spill, checkpoint and import share this route). The record carries
        the tree's per-leaf digests, independent of the blob, so a swapped or
        stale blob fails re-admission. ``defer_journal`` returns the entry
        for a batched append. On a pod bank only mesh rank 0 seals and
        writes the payload; every process keeps the record's bookkeeping."""
        key = self._blob_key(tenant)
        sealed: List[bytes] = []

        def put() -> None:
            sealed.append(_spill.encode_tenant_payload(tree))
            self._store.put(key, sealed[0])

        self._store_write(put)
        nbytes = len(sealed[0]) if sealed else 0
        health = self._health_list(tree)
        digest = _integrity.state_digest(tree)
        record = _spill.seal_record(
            {"op": op, "t": _spill.durable_token(tenant), "count": int(count), "health": health, "digest": digest}
        )
        entry: Optional[Tuple[str, Hashable, bytes]] = None
        if defer_journal:
            entry = (op, tenant, record)
        else:
            self._journal_many([(op, tenant, record)])
        self._durable_counts[tenant] = int(count)
        self._durable_health[tenant] = health
        self._durable_digest[tenant] = digest
        _spill.bump("spill_writes")
        _spill.bump("spill_bytes", nbytes)
        if _bus.enabled():
            _bus.emit(
                "spill_write",
                source=type(self._template).__name__,
                bank=self.name,
                tenant=str(tenant),
                op=op,
                bytes=nbytes,
            )
        return entry

    def _index_spilled(self, tenant: Hashable) -> None:
        self._spilled[tenant] = self._blob_key(tenant)
        health = self._durable_health.get(tenant)
        if health is not None:
            self._spilled_health += np.asarray(health, np.int64)

    def _unindex_spilled(self, tenant: Hashable) -> None:
        self._spilled.pop(tenant)
        health = self._durable_health.get(tenant)
        if health is not None:
            self._spilled_health -= np.asarray(health, np.int64)

    def _live_record(self, tenant: Hashable) -> bytes:
        return _spill.seal_record(
            {
                "op": "checkpoint",
                "t": _spill.durable_token(tenant),
                "count": int(self._durable_counts.get(tenant, 0)),
                "health": self._durable_health.get(tenant),
                "digest": self._durable_digest.get(tenant),
            }
        )

    def _maybe_compact_journal(self) -> None:
        """Past 4x the live sessions (at least 256 records), rewrite the
        journal as one checkpoint record per live session: replay-equivalent,
        and the attestations are kept."""
        live = len(self._slots) + len(self._spilled)
        if self._journal_len <= max(256, 4 * live):
            return
        records = [self._live_record(t) for t in list(self._slots) + list(self._spilled)]
        self._store_write(lambda: self._store.rewrite_journal(self.name, records))
        self._journal_len = len(records)
        _spill.bump("journal_compactions")

    def checkpoint_lag(self) -> int:
        """Updates applied but not yet durable, summed over resident tenants."""
        with self._lock:
            return sum(self._counts[t] - self._durable_counts.get(t, 0) for t in self._slots)

    def set_checkpoint_cadence(self, every_n_flushes: Optional[int]) -> None:
        """Re-tune the periodic checkpoint cadence (None disables it)."""
        if every_n_flushes is not None and every_n_flushes < 1:
            raise ValueError(f"checkpoint cadence must be >= 1 (or None), got {every_n_flushes}")
        with self._lock:
            self._ckpt_every = every_n_flushes

    @property
    def checkpoint_cadence(self) -> Optional[int]:
        return self._ckpt_every

    def checkpoint(self, tenants: Optional[Iterable[Hashable]] = None) -> int:
        """Seal resident tenants' current states into the store now (every
        dirty resident tenant by default); returns the number checkpointed.
        One coalesced copy to the host covers the batch."""
        with self._lock:
            todo = list(self._dirty) if tenants is None else list(tenants)
            return self._checkpoint_locked(todo)

    def _checkpoint_locked(self, tenants: List[Hashable]) -> int:
        tenants = [t for t in tenants if t in self._slots]
        if not tenants:
            # an async-staged batch still gets sealed, and its tenants count
            return self._seal_pending_checkpoint()
        if self._ckpt_async:
            return self._stage_checkpoint_async(tenants)
        # the JAX bank gathers rows (counted) on a mesh or for a minority of
        # the residents, and fetches its whole bank (not counted) otherwise
        count = self._mesh is not None or 2 * len(tenants) < len(self._slots)
        host = self._fetch_rows([self._slots[t] for t in tenants], count_gather=count)
        entries = []
        for tenant, state in zip(tenants, host):
            tree = self._encode_state(state, self._counts[tenant])
            entries.append(
                self._write_tenant_blob(tenant, tree, self._counts[tenant], op="checkpoint", defer_journal=True)
            )
            self._dirty.pop(tenant, None)
        self._journal_many([e for e in entries if e is not None])
        self.stats["checkpoints"] += 1
        _spill.bump("checkpoints")
        self._maybe_compact_journal()
        return len(tenants)

    def _gathered_rows(self, rows: List[int], names: Optional[List[str]] = None) -> Dict[str, torch.Tensor]:
        """The global rows of the slots ``rows`` (of the leaves ``names``,
        default all), in fresh tensors (safe against later waves): gathered
        on the device, or on a pod bank whose rows are split, the read
        exchange's host tensors (a collective; the same on every process)."""
        names = list(self._bank) if names is None else names
        if self._pod is not None and self._pod.split:
            return self._pod.exchange(self._resident, rows, names)
        idx = _index(rows, self._device)
        return {n: self._bank[n].index_select(0, idx) for n in names}

    def _fetch_rows(self, rows: List[int], count_gather: bool = False) -> List[Dict[str, torch.Tensor]]:
        """Copies of the rows on the host, in one coalesced copy; one state
        dict per row. ``count_gather`` counts it in ``coalesced_gathers`` (the
        JAX bank counts only its row gathers, not its whole-bank fetches)."""
        from metrics_tpu_torch.engine.driver import AsyncResult

        if count_gather:
            self.stats["coalesced_gathers"] += 1
        host = AsyncResult(self._gathered_rows(rows), source=f"bank:{self.name}:fetch").result()
        return [{n: col[i] for n, col in host.items()} for i in range(len(rows))]

    def _stage_checkpoint_async(self, tenants: List[Hashable]) -> int:
        """The serving half of an async checkpoint: one row gather and an
        :class:`~metrics_tpu_torch.engine.AsyncResult` copy; the seal happens
        at the next boundary."""
        from metrics_tpu_torch.engine.driver import AsyncResult

        self.stats["coalesced_gathers"] += 1
        gathered = self._gathered_rows([self._slots[t] for t in tenants])
        handle = AsyncResult(gathered, source=f"bank:{self.name}:checkpoint")
        prev = self._pending_ckpt
        self._pending_ckpt = (handle, [(t, self._counts[t], self._gen.get(t)) for t in tenants])
        for t in tenants:
            self._dirty.pop(t, None)
        self.stats["checkpoints"] += 1
        _spill.bump("checkpoints")
        if prev is not None:
            self._seal_staged(prev)
        return len(tenants)

    def _seal_pending_checkpoint(self) -> int:
        pending, self._pending_ckpt = self._pending_ckpt, None
        if pending is None:
            return 0
        return self._seal_staged(pending)

    def _seal_staged(self, staged: Tuple[Any, List[Tuple[Hashable, int, Optional[int]]]]) -> int:
        handle, metas = staged
        host = handle.result()
        entries = []
        sealed = 0
        for i, (tenant, count, gen) in enumerate(metas):
            # a later durable write or a drop superseded the staged rows; the
            # generation catches a drop followed by a re-admission
            if self._gen.get(tenant) != gen:
                continue
            durable = self._durable_counts.get(tenant)
            if durable is None or durable >= count:
                continue
            tree = self._encode_state({n: col[i] for n, col in host.items()}, count)
            entries.append(self._write_tenant_blob(tenant, tree, count, op="checkpoint", defer_journal=True))
            sealed += 1
        self._journal_many([e for e in entries if e is not None])
        self._maybe_compact_journal()
        return sealed

    @classmethod
    def recover(cls, template: Any, capacity: int, store: _spill.SpillStore, *, name: str, **bank_kwargs: Any) -> "MetricBank":
        """Rebuild the bank named ``name`` from its journal in ``store``
        after the process died: every session admitted or imported and not
        dropped is staged spilled at its last durable state (never
        checkpointed sessions at the defaults) and re-admits on demand. A
        torn or crc-corrupted journal tail is ignored and the journal is
        rewritten, one checkpoint record per live session. Idempotent.
        ``bank_kwargs`` go to the new bank, ``mesh=`` and ``tenant_axis=``
        too: a journal rebuilds into a fresh pod bank, whatever layout wrote
        it (every process of the mesh calls ``recover``; mesh rank 0 reads
        the store)."""
        bank = cls(template, capacity, name=name, spill_store=store, **bank_kwargs)
        with bank._lock:
            live, torn = bank._store_read(lambda: _spill.replay_journal(store, name))
            keys = [_spill.tenant_blob_key(name, _spill.durable_token(t)) for t in live]

            def restore_defaults() -> None:
                for key in keys:
                    if not store.exists(key):
                        # admitted write-ahead, but the crash took the defaults blob
                        store.put(key, bank._defaults_sealed())

            bank._store_write(restore_defaults)
            for tenant, rec in live.items():
                bank._durable_counts[tenant] = int(rec.get("count", 0))
                health = rec.get("health")
                bank._durable_health[tenant] = [int(x) for x in health] if health is not None else None
                bank._durable_digest[tenant] = rec.get("digest")
                bank._gen[tenant] = bank._gen_next
                bank._gen_next += 1
                bank._index_spilled(tenant)
            records = [bank._live_record(t) for t in live]
            records.append(_spill.seal_record({"op": "recover", "n": len(live), "torn": torn}))
            # rewrite, never append: the journal may end in the torn frame
            # the crash left, which would swallow later records
            bank._store_write(lambda: store.rewrite_journal(name, records))
            bank._journal_len = len(records)
            _spill.bump("journal_compactions")
        _spill.bump("recovers")
        _spill.bump("recovered_tenants", len(live))
        if _bus.enabled():
            _bus.emit(
                "recover",
                source=type(bank._template).__name__,
                bank=name,
                tenants=len(live),
                torn_records=torn,
                persistent=store.persistent,
            )
        return bank

    # ------------------------------------------------------------------
    # handoff between banks
    # ------------------------------------------------------------------
    def export_tenant(self, tenant: Hashable, keep: bool = False) -> Dict[str, Any]:
        """The tenant's checkpoint tree (what a spill seals), for handing the
        session to another bank; ``keep=False`` removes it from this one."""
        with self._lock:
            payload = self._export_payload_locked(tenant, keep)
            return _spill.decode_tenant_payload(payload, context=f" (bank {self.name!r}, tenant {tenant!r})")

    def export_payload(self, tenant: Hashable, keep: bool = False) -> bytes:
        """The tenant's sealed durable payload, removing the session unless ``keep``."""
        with self._lock:
            return self._export_payload_locked(tenant, keep)

    def _export_payload_locked(self, tenant: Hashable, keep: bool) -> bytes:
        if tenant in self._slots:
            self._evict_locked(tenant, spill=True)
        if tenant not in self._spilled:
            raise KeyError(f"unknown tenant {tenant!r} in bank {self.name!r}")
        key = self._spilled[tenant]
        payload = self._store_read(lambda: self._store.get(key))
        _spill.bump("blob_reads")
        self.stats["exports"] += 1
        if not keep:
            self._drop_spilled_entry(tenant, op="export")
        return payload

    def import_tenant(self, tenant: Hashable, tree: Dict[str, Any], admit: bool = True) -> None:
        """Stage a checkpoint tree (an :meth:`export_tenant` tree or a decoded
        payload) into this bank. The tree is validated on a template clone
        (the checkpoint restore and ``bind_state``) before the bank learns
        the tenant, and sealed into the store before it is served;
        ``admit=False`` leaves it spilled."""
        from metrics_tpu_torch.utils import checkpoint as _ckpt

        with self._lock:
            if tenant in self._slots or tenant in self._spilled:
                raise MetricsUserError(
                    f"bank {self.name!r} already serves tenant {tenant!r};"
                    " evict/export it before importing a new state for it."
                )
            probe = self._template.clone()
            if self._is_collection:
                nested = self._nest(dict(tree))
                staged: Dict[str, Any] = {}
                count = 0
                for k, pm in probe._modules.items():
                    _ckpt.restore_metric_state_pytree(pm, dict(nested[k]))
                    pm.bind_state(pm._snapshot_state(), update_count=pm._update_count)
                    count = max(count, pm._update_count)
                    for n, v in _ckpt.metric_state_pytree(pm).items():
                        staged[f"{k}::{n}"] = v
            else:
                _ckpt.restore_metric_state_pytree(probe, dict(tree))
                probe.bind_state(probe._snapshot_state(), update_count=probe._update_count)
                staged = _ckpt.metric_state_pytree(probe)
                count = probe._update_count
            self._write_tenant_blob(tenant, staged, count, op="import")
            self._index_spilled(tenant)
            self._gen[tenant] = self._gen_next
            self._gen_next += 1
            self.stats["imports"] += 1
            self._maybe_compact_journal()
            if admit:
                self.admit(tenant)

    # ------------------------------------------------------------------
    # state integrity: shadow audits and repair
    # ------------------------------------------------------------------
    def _capture_audit(self, requests: List[Tuple[Hashable, Tuple[Any, ...]]], audit: Tuple) -> None:
        """Finish a sampled audit: copy the tenant's post row and hand both
        copies to an :class:`~metrics_tpu_torch.engine.AsyncResult`."""
        from metrics_tpu_torch.engine.driver import AsyncResult

        tenant, count_before, pre, flush_index = audit
        post = self._row_copy(self._slots[tenant])
        capture = AsyncResult({"pre": pre, "post": post}, source=f"bank:{self.name}:audit")
        entry = _integrity.AuditEntry(
            tenant=tenant,
            args_list=[args for t, args in requests if t == tenant],
            count_before=count_before,
            capture=capture,
            flush_index=flush_index,
        )
        if len(self._pending_audits) >= 64:
            # an auditor that stopped polling must not pin device memory
            self._pending_audits.pop(0)
            _integrity.bump("audits_dropped")
        self._pending_audits.append(entry)
        self.stats["audits_sampled"] += 1
        _integrity.bump("audits_sampled")
        # replay-neutral: a durable trace of which flushes were audited
        self._journal("audit", tenant, count=int(self._counts[tenant]), flush=int(flush_index))

    def take_audits(self) -> List[Any]:
        """Drain the pending audit captures, oldest first."""
        with self._lock:
            out = list(self._pending_audits)
            self._pending_audits.clear()
        return out

    def repair_tenant(self, tenant: Hashable) -> int:
        """Drop ``tenant``'s resident state without spilling it (that would
        seal the corruption as truth) and re-admit it from its last attested
        blob, through both digest checks; returns the restored update count.
        Updates since that checkpoint are lost, the window a crash loses.
        Emits a ``repair`` event."""
        with self._lock:
            resident = tenant in self._slots
            if not resident and tenant not in self._spilled:
                raise KeyError(f"tenant {tenant!r} is not served by bank {self.name!r}")
            if tenant not in self._durable_counts and tenant not in self._spilled:
                raise StateIntegrityError(
                    f"cannot repair tenant {tenant!r} on bank {self.name!r}:"
                    " no durable checkpoint exists to rebuild from",
                    bank=self.name,
                    tenant=tenant,
                )
            if resident:
                slot = self._slots.pop(tenant)
                self._counts.pop(tenant)
                self._lru.pop(tenant, None)
                self._dirty.pop(tenant, None)
                self._release_slot(slot)
                self._index_spilled(tenant)
            self.admit(tenant)
            restored = int(self._counts[tenant])
            self.stats["repairs"] += 1
            _integrity.bump("repairs")
            if _bus.enabled():
                _bus.emit(
                    "repair", source=type(self._template).__name__, bank=self.name, tenant=str(tenant), count=restored
                )
            return restored

    # -- slot <-> state plumbing ----------------------------------------
    def _row_copy(self, slot: int) -> Dict[str, torch.Tensor]:
        """A copy of one row (the bank is written in place), on the bank's
        device; on a pod bank whose rows are split, the global row through
        the read exchange (a collective)."""
        if self._pod is not None and self._pod.split:
            return {n: col[0].to(self._device) for n, col in self._gathered_rows([slot]).items()}
        return {n: leaf[slot].clone() for n, leaf in self._bank.items()}

    def _write_slots(self, writes: Dict[int, Dict[str, Any]]) -> None:
        """Write global rows into their slots: on a pod bank, the slots this
        process owns, each leaf's slice of this process."""
        for slot in sorted(writes):
            if not self._owns(slot):
                continue
            row, at = writes[slot], self._local_row(slot)
            for n, leaf in self._bank.items():
                value = torch.as_tensor(row[n])
                if self._pod is not None:
                    value = self._pod.local_value(n, value)
                leaf[at].copy_(value.to(dtype=leaf.dtype))

    @staticmethod
    def _with_state(m: Any, state: Dict[str, Any], fn: Any) -> Any:
        """Run ``fn`` with member ``m`` holding ``state``, then put its own
        states and update count back."""
        saved, saved_count = m._snapshot_state(), m._update_count
        try:
            m._restore_state(state)
            return fn()
        finally:
            m._restore_state(saved)
            m._update_count = saved_count

    def _encode_state(self, state: Dict[str, Any], count: int) -> Dict[str, Any]:
        """One tenant's state through the checkpoint encode (a spilled tenant
        is a checkpointed metric); a collection tenant's tree is each
        member's tree under ``"member::field"`` names."""
        from metrics_tpu_torch.utils import checkpoint as _ckpt

        def encode(m: Any) -> Dict[str, Any]:
            m._update_count = count
            return _ckpt.metric_state_pytree(m)

        if not self._is_collection:
            return self._with_state(self._template, state, lambda: encode(self._template))
        nested = self._nest(state)
        tree: Dict[str, Any] = {}
        for k, m in zip(self._member_keys, self._members):
            for n, v in self._with_state(m, nested[k], lambda m=m: encode(m)).items():
                tree[f"{k}::{n}"] = v
        return tree

    def _read_blobs(self, tenants: List[Hashable]) -> Dict[Hashable, bytes]:
        """The spilled tenants' payloads, read ahead on a pod bank: by mesh
        rank 0, handed to every process in one broadcast. Empty off a mesh
        (:meth:`_decode_spilled` reads each one itself)."""
        if self._pod is None or not tenants:
            return {}
        keys = {t: self._spilled[t] for t in tenants}
        return self._store_read(lambda: {t: self._store.get(k) for t, k in keys.items()})

    def _decode_spilled(self, tenant: Hashable, payload: Optional[bytes] = None) -> Tuple[Dict[str, Any], int]:
        from metrics_tpu_torch.utils import checkpoint as _ckpt

        if payload is None:
            key = self._spilled[tenant]
            payload = self._store_read(lambda: self._store.get(key))
        _spill.bump("blob_reads")
        tree = _spill.decode_tenant_payload(payload, context=f" (bank {self.name!r}, tenant {tenant!r})")
        # the journal's digests are independent of the blob's own, so a
        # stale-but-self-consistent or swapped blob is caught here
        _integrity.verify_tree(
            tree,
            self._durable_digest.get(tenant),
            bank=self.name,
            tenant=tenant,
            context=f" (bank {self.name!r}, tenant {tenant!r}, journal attestation)",
        )

        def decode(m: Any, part: Dict[str, Any]) -> Tuple[Dict[str, Any], int]:
            _ckpt.restore_metric_state_pytree(m, dict(part))
            return m._snapshot_state(), m._update_count

        if not self._is_collection:
            tpl = self._template
            return self._with_state(tpl, tpl._snapshot_state(), lambda: decode(tpl, tree))
        nested = self._nest(tree)
        state: Dict[str, Any] = {}
        count = 0
        for k, m in zip(self._member_keys, self._members):
            member_state, member_count = self._with_state(m, m._snapshot_state(), lambda m=m, k=k: decode(m, nested[k]))
            for n, v in member_state.items():
                state[f"{k}::{n}"] = v
            count = max(count, member_count)
        return state, count

    # ------------------------------------------------------------------
    # batched dispatch (data plane)
    # ------------------------------------------------------------------
    def update(self, tenant: Hashable, *args: Any) -> None:
        """Apply one tenant's update (a one-request wave)."""
        self.apply_batch([(tenant, args)])

    def apply_batch(
        self, requests: Sequence[Tuple[Hashable, Tuple[Any, ...]]], request_ids: Optional[Sequence[Any]] = None
    ) -> int:
        """Apply a wave of ``(tenant, update args)`` requests in one program;
        returns the requests consumed (applied and exactly-once duplicates
        dropped). At most one request per tenant, one input signature (exact,
        or batch sizes in one pow2 bucket with ``jit_bucket="pow2"``) and at
        most ``capacity`` requests: a :class:`RequestRouter` guarantees all
        three. ``request_ids`` (aligned, entries may be None) drive the
        shared :class:`RequestDedup`; a failing wave releases its claims.
        A failed apply is counted (``flush_errors``) and emitted as a
        ``flush`` event carrying ``error``."""
        if not requests:
            return 0
        requests = list(requests)
        request_ids = list(request_ids) if request_ids is not None else None
        # the caller's mistakes raise before the flush-error accounting
        tenants = [t for t, _ in requests]
        if len(set(tenants)) != len(tenants):
            raise ValueError(
                "apply_batch got multiple requests for one tenant in a single"
                " batch; the second update would race the first inside one"
                " launch. Queue them as separate waves (RequestRouter does)."
            )
        if len(requests) > self.capacity:
            raise ValueError(
                f"batch of {len(requests)} requests exceeds bank capacity"
                f" {self.capacity}; split it (RequestRouter clamps flushes)."
            )
        if request_ids is not None and len(request_ids) != len(requests):
            raise ValueError(f"request_ids ({len(request_ids)}) must align with requests ({len(requests)})")
        with self._lock:
            try:
                return self._apply_batch_locked(requests, request_ids)
            except Exception as err:
                self.stats["flush_errors"] += 1
                if _bus.enabled():
                    _bus.emit(
                        "flush",
                        source=type(self._template).__name__,
                        bank=self.name,
                        requests=len(requests),
                        error=type(err).__name__,
                        occupancy=len(self._slots),
                    )
                raise

    def _apply_batch_locked(
        self, requests: List[Tuple[Hashable, Tuple[Any, ...]]], request_ids: Optional[List[Any]] = None
    ) -> int:
        """One wave in three phases, each a span while :func:`obs.trace.active`:
        ``bank.prepare`` (dedup, the requests' structure and padding,
        admission), ``bank.dispatch`` (stacking and the wave's program) and
        ``bank.write_back`` (the rows, counts and cadence work)."""
        t_start = time.perf_counter()
        consumed = len(requests)
        if _trace.active():
            with _trace.span("bank.prepare", "MetricBank"):
                wave = self._prepare_wave(requests, request_ids)
            if wave is None:
                return consumed
            if wave.err is None:
                with _trace.span("bank.dispatch", "MetricBank"):
                    self._launch_wave(wave)
            with _trace.span("bank.write_back", "MetricBank"):
                self._commit_wave(wave)
        else:
            wave = self._prepare_wave(requests, request_ids)
            if wave is None:
                return consumed  # every request was a duplicate: no launch
            if wave.err is None:
                self._launch_wave(wave)
            self._commit_wave(wave)
        ms = self._record_ms(t_start)
        if _bus.enabled():
            _bus.emit(
                "flush",
                source=type(self._template).__name__,
                bank=self.name,
                requests=wave.n_req,
                variant="dense" if wave.dense else "scatter",
                bucketed=wave.pads is not None,
                shard_launches=wave.n_launches,
                occupancy=len(self._slots),
                ms=round(ms, 3),
            )
        return consumed

    def _prepare_wave(
        self, requests: List[Tuple[Hashable, Tuple[Any, ...]]], request_ids: Optional[List[Any]]
    ) -> Optional["_Wave"]:
        """A wave up to its launch, or None where every request was a
        duplicate. A failure after the processes agreed on the requests is
        kept in ``err``, for :meth:`_commit_wave` to raise once agreed."""
        wave = _Wave()
        claimed: List[Tuple[Hashable, Any]] = []
        prepared: Any = None
        err: Optional[BaseException] = None
        try:
            if self.fault_injector is not None:
                self.fault_injector()
            if self._dedup is not None and request_ids is not None:
                kept: List[Tuple[Hashable, Tuple[Any, ...]]] = []
                for (tenant, args), rid in zip(requests, request_ids):
                    if rid is not None:
                        if not self._dedup.begin(tenant, rid, owner=self.name):
                            self.stats["dedup_dropped"] += 1
                            continue
                        claimed.append((tenant, rid))
                    kept.append((tenant, args))
                requests = kept
            if requests:
                prepared = self._prepare(
                    [args for _, args in requests], "apply_batch requests disagree on update-argument structure;"
                    " group by signature first (RequestRouter does)."
                )
        except Exception as e:
            err = e
        tenants = [t for t, _ in requests]
        # a pod bank's processes agree before any state is touched: the
        # same tenants on every process, and no process failed its checks
        self._agree_or_release(err, claimed, "apply_batch", tenants)
        if not requests:
            return None
        wave.requests, wave.claimed, wave.tenants = requests, claimed, tenants
        wave.leaves_per_req, wave.spec, wave.pads = prepared
        try:
            wave.entry = self._entry()
            wave.stats = _cache.instance_stats(self._template)
            wave.slots = self._admit_many(tenants)
            if self._audit_period is not None:
                self._flush_index += 1
                if self._flush_index % self._audit_period == 0:
                    pick = tenants[self._audit_cursor % len(tenants)]
                    self._audit_cursor += 1
                    wave.audit = (pick, int(self._counts[pick]), self._row_copy(self._slots[pick]), self._flush_index)
            wave.n_req = len(requests)
            wave.dense = wave.n_req >= self.dense_threshold * self.capacity
            # the JAX bank's launches: one dense program, or one shard-local
            # scatter program per tenant shard the wave touches
            wave.n_launches = 1 if wave.dense else len({self._slot_shard(s) for s in wave.slots})
        except Exception as e:
            wave.err = e
        return wave

    def _launch_wave(self, wave: "_Wave") -> None:
        """The wave's program; its new rows, or its failure, kept on ``wave``."""
        try:
            wave.staged = self._dispatch_wave(
                wave.entry, wave.stats, wave.slots, wave.leaves_per_req, wave.spec, wave.pads
            )
        except Exception as e:
            wave.err = e

    def _commit_wave(self, wave: "_Wave") -> None:
        """Commit a wave only where it succeeded (on a pod bank, on every
        process of the mesh): its rows, the exactly-once claims, the counts
        and the cadence work; else release its claims and raise."""
        self._agree_or_release(wave.err, wave.claimed)
        self._write_back(wave.staged)
        self._share_init(wave.slots[0])
        for tenant, rid in wave.claimed:
            self._dedup.commit(tenant, rid)
        for t in wave.tenants:
            self._counts[t] += 1
            self._dirty[t] = None
        self.stats["launches"] += wave.n_launches
        self.stats["requests"] += wave.n_req
        self.stats["dense_launches" if wave.dense else "scatter_launches"] += wave.n_launches
        if wave.pads is not None:
            self.stats["bucketed_requests"] += wave.n_req
        self._after_apply(wave.tenants)
        if wave.audit is not None:
            self._capture_audit(wave.requests, wave.audit)

    def _release(self, claimed: List[Tuple[Hashable, Any]]) -> None:
        """Release a failed wave's exactly-once claims: the router re-queues
        failed requests, and their retry must apply."""
        for tenant, rid in claimed:
            self._dedup.abort(tenant, rid)

    def _agree_or_release(
        self,
        err: Optional[BaseException],
        claimed: List[Tuple[Hashable, Any]],
        call: Optional[str] = None,
        tenants: Sequence[Hashable] = (),
    ) -> None:
        """Raise ``err`` (releasing the claims), or on a pod bank agree with
        the other processes first: every process raises when one failed,
        and with ``call`` the processes' requests and bookkeeping must
        match (calls made out of step raise :class:`MetricsUserError`)."""
        if self._pod is None:
            if err is not None:
                self._release(claimed)
                raise err
            return
        digest = describe = None
        if call is not None:
            tokens = [str(_spill.durable_token(t)) for t in tenants]
            rows = sorted((str(_spill.durable_token(t)), slot, self._counts[t]) for t, slot in self._slots.items())
            digest = repr((call, tokens, rows, sorted(str(_spill.durable_token(t)) for t in self._spilled))).encode()

            def describe() -> Tuple[List[str], List[Tuple]]:
                return tokens, rows

        try:
            self._pod.agree(err, digest, describe, f"MetricBank {self.name!r} {call or 'wave'}")
        except BaseException:
            self._release(claimed)
            raise

    def _share_init(self, slot: int) -> None:
        """After a pod bank's first applied wave: what the members learned in
        their first update (``_dynamic_state_attrs``), from the first process
        that ran the wave's first request, on every process and on the
        global template (which computes and encodes)."""
        if self._init_shared:
            return
        pod = self._pod
        src = min(r for r in range(pod.world) if pod.shards[r] == pod.shard_of_slot(slot))
        learned = [{a: getattr(m, a) for a in m._dynamic_state_attrs} for m in self._cell_members]
        learned = pod.broadcast(learned, src)
        for attrs, cell, member in zip(learned, self._cell_members, self._members):
            for a, v in attrs.items():
                setattr(cell, a, v)
                setattr(member, a, v)
        self._init_shared = True
        if any(learned):
            # the JAX bank learns them ahead of its first admission: the
            # defaults blobs of this wave's new tenants carry them there
            self._defaults_payload = None
            for tenant in self._fresh:
                if tenant in self._slots and self._durable_digest.get(tenant) is None:
                    key = self._blob_key(tenant)
                    self._store_write(lambda key=key: self._store.put(key, self._defaults_sealed()))

    def _write_back(self, staged: Any) -> None:
        """A wave or an epoch that succeeded (on a pod bank, on every
        process): its new rows into this process's resident leaves
        (``(local row index, {leaf: rows})``, or None where this process
        ran nothing)."""
        if staged is None:
            return
        idx, rows = staged
        for n, leaf in self._resident.items():
            leaf.index_copy_(0, idx, rows[n])

    def _after_apply(self, tenants: List[Hashable]) -> None:
        """The cadence checkpoint, then the silent-corruption seam (a flip
        lands on state already attested clean)."""
        if self._ckpt_every is not None:
            self._flushes_since_ckpt += 1
            if self._flushes_since_ckpt >= self._ckpt_every:
                self._flushes_since_ckpt = 0
                self._checkpoint_locked(list(self._dirty))
        if self.state_fault_injector is not None:
            self.state_fault_injector(list(tenants))

    def _record_ms(self, t_start: float) -> float:
        ms = (time.perf_counter() - t_start) * 1000.0
        self._last_flush_ms = ms
        self._flush_ms_ewma = ms if self._flush_ms_ewma is None else 0.8 * self._flush_ms_ewma + 0.2 * ms
        return ms

    def _prepare(self, args_list: List[Tuple[Any, ...]], structure_error: str) -> Tuple[List[List[Any]], Any, Optional[List[int]]]:
        """Flatten the requests, check they share one structure, run the
        Python-init probe's bookkeeping and pad ragged batches to their pow2
        bucket; ``(leaves per request, structure, pad counts or None)``."""
        flat = [_tree.flatten((tuple(args), {})) for args in args_list]
        spec = flat[0][1]
        if any(s != spec for _, s in flat[1:]):
            raise ValueError(structure_error)
        leaves_per_req = [[_host_tensor(x) for x in leaves] for leaves, _ in flat]
        batched = _bucketing.batched_leaf_indices(leaves_per_req[0])
        pads = self._unify_shapes(leaves_per_req, batched)
        return leaves_per_req, spec, pads

    def _unify_shapes(self, leaves_per_req: List[List[Any]], batched: Tuple[int, ...]) -> Optional[List[int]]:
        """Pad ragged request batches into one shape (pow2 bucketing, as a
        solo ``jit_bucket="pow2"`` instance does); the per-request pad counts,
        or None for an exact-shape wave. Pads ``leaves_per_req`` in place."""
        sigs = [tuple(_sig_of(x) for x in leaves) for leaves in leaves_per_req]
        if not self._bucketing_active(batched):
            if any(s != sigs[0] for s in sigs[1:]):
                raise ValueError(
                    "apply_batch requests disagree on input shapes/dtypes and"
                    f" {type(self._template).__name__} did not opt into"
                    " jit_bucket='pow2'; group by exact signature first."
                )
            return None
        batch_sizes = [int(leaves[batched[0]].shape[0]) for leaves in leaves_per_req]
        bucket = _bucketing.next_pow2(max(batch_sizes))
        pads = [bucket - b for b in batch_sizes]
        for i, leaves in enumerate(leaves_per_req):
            leaves_per_req[i] = _bucketing.pad_leaves(leaves, batched, pads[i])
        padded = [tuple(_sig_of(x) for x in leaves) for leaves in leaves_per_req]
        if any(s != padded[0] for s in padded[1:]):
            raise ValueError(
                "apply_batch requests differ beyond the batch axis (trailing dims or dtypes); group by signature first."
            )
        return pads

    def _stack(self, leaves_per_req: List[List[Any]]) -> List[Any]:
        """One input per leaf position: the requests' tensors stacked on the
        bank's device (host requests through pinned memory, copied without
        a host sync), or a shared non-tensor value."""
        out: List[Any] = []
        for col in zip(*leaves_per_req):
            if all(isinstance(x, torch.Tensor) for x in col):
                if self._device.type == "cuda" and all(x.device.type == "cpu" for x in col):
                    pinned = torch.empty((len(col),) + tuple(col[0].shape), dtype=col[0].dtype, pin_memory=True)
                    out.append(torch.stack(list(col), out=pinned).to(self._device, non_blocking=True))
                else:
                    out.append(torch.stack(list(col)).to(self._device))
            elif all(x == col[0] for x in col[1:]):
                out.append(col[0])
            else:  # Python scalars that differ between requests travel as a tensor
                out.append(torch.as_tensor(np.stack([np.asarray(x) for x in col]), device=self._device))
        return out

    def _dispatch_wave(
        self,
        entry: Any,
        stats: Dict[str, int],
        slots: List[int],
        leaves_per_req: List[List[Any]],
        spec: Any,
        pads: Optional[List[int]],
    ) -> Any:
        """Pad the request axis to its pow2 bucket (pad requests address the
        sink row, with zero inputs) and run the wave's program; its new rows
        for :meth:`_write_back` (``(local row index, rows)``). On a pod bank
        only the requests whose slot this process owns are staged and run
        (None when it owns none)."""
        if self._pod is not None:
            owned = [i for i, slot in enumerate(slots) if self._owns(slot)]
            if not owned:
                return None
            slots = [slots[i] for i in owned]
            leaves_per_req = [leaves_per_req[i] for i in owned]
            pads = [pads[i] for i in owned] if pads is not None else None
        n_req = len(slots)
        n_padded = _bucketing.next_pow2(n_req)
        if _trace.active():
            _trace.count("bank.rows_launched", n_padded)
            _trace.count("bank.rows_padded", n_padded - n_req)
        rows = list(leaves_per_req)
        slot_ids = [self._local_row(slot) for slot in slots]
        req_pads = list(pads) if pads is not None else None
        if n_padded > n_req:
            zero_row = [torch.zeros_like(x) if isinstance(x, torch.Tensor) else x for x in leaves_per_req[0]]
            for _ in range(n_padded - n_req):
                rows.append(zero_row)
                slot_ids.append(self.shard_capacity)
                if req_pads is not None:
                    req_pads.append(0)
        args, kwargs = _tree.unflatten(spec, self._stack(rows))
        idx = _index(slot_ids, self._device)
        inputs: Tuple[Any, ...] = (idx, args, kwargs)
        variant = "wave"
        if req_pads is not None:
            variant += "_pad"
            inputs += (_index(req_pads, self._device),)
        return idx, self._run(entry, stats, variant, inputs)

    def _run(self, entry: Any, stats: Dict[str, int], variant: str, inputs: Tuple[Any, ...]) -> Any:
        """One bank program on the resident leaves; the members' own states
        are put back afterwards (the body binds each row onto them)."""
        cell = self._cell()
        saved = self._snapshot_templates()
        try:
            out = entry.invoke(variant, cell, stats, *inputs, probe=not _cache.probed(cell), resident=self._resident)
        finally:
            self._restore_templates(saved)
        _cache.mark_probed(cell)
        return out

    def drive(self, tenant: Hashable, batches: Iterable[Tuple[Any, ...]]) -> int:
        """Fold a whole per-tenant epoch into its row in one program, the
        bank-level ``engine.drive``: ``batches`` is a sequence of update
        argument tuples applied in order, bit-identical to that many
        one-request flushes. With ``jit_bucket="pow2"`` ragged steps are
        padded to their bucket and the step count to a power of two (whole
        no-op steps), so epoch lengths share O(log K) programs. Returns the
        real steps applied; counts as one flush for the checkpoint cadence.
        Collection banks take their epochs as waves. Emits ``bank_drive``."""
        batches = [b if isinstance(b, tuple) else (b,) for b in batches]
        if not batches:
            return 0
        if self._is_collection:
            raise MetricsUserError(
                "collection banks do not support bank-level drive; feed the"
                " epoch through apply_batch waves (one fused launch each)."
            )
        with self._lock:
            try:
                return self._drive_locked(tenant, batches)
            except Exception as err:
                self.stats["flush_errors"] += 1
                if _bus.enabled():
                    _bus.emit(
                        "bank_drive",
                        source=type(self._template).__name__,
                        bank=self.name,
                        tenant=str(tenant),
                        steps=len(batches),
                        error=type(err).__name__,
                        occupancy=len(self._slots),
                    )
                raise

    def _drive_locked(self, tenant: Hashable, batches: List[Tuple[Any, ...]]) -> int:
        t_start = time.perf_counter()
        prepared: Any = None
        err: Optional[BaseException] = None
        try:
            if self.fault_injector is not None:
                self.fault_injector()
            prepared = self._prepare(
                batches, "drive() batches disagree on update-argument structure; an epoch scans ONE program over"
                " uniformly-shaped steps."
            )
        except Exception as e:
            err = e
        self._agree_or_release(err, [], "drive", [tenant])
        leaves_per_step, spec, pads = prepared
        staged: Any = None
        try:
            entry = _cache.bank_drive_entry(self._cell_template, layout=self._resident.layout)
            stats = _cache.instance_stats(self._template)
            slot = self._admit_many([tenant])[0]
            n_steps = len(batches)
            if self._owns(slot):
                staged = self._scan(entry, stats, slot, leaves_per_step, spec, pads)
        except Exception as e:
            err = e
        self._agree_or_release(err, [])
        self._write_back(staged)
        self._share_init(slot)
        self._counts[tenant] += n_steps
        self._dirty[tenant] = None
        self.stats["launches"] += 1
        self.stats["requests"] += n_steps
        self.stats["bank_drives"] += 1
        self.stats["drive_steps"] += n_steps
        if pads is not None:
            self.stats["bucketed_requests"] += n_steps
        self._after_apply([tenant])
        ms = self._record_ms(t_start)
        if _bus.enabled():
            _bus.emit(
                "bank_drive",
                source=type(self._template).__name__,
                bank=self.name,
                tenant=str(tenant),
                steps=n_steps,
                bucketed=pads is not None,
                occupancy=len(self._slots),
                ms=round(ms, 3),
            )
        return n_steps

    def _scan(
        self,
        entry: Any,
        stats: Dict[str, int],
        slot: int,
        leaves_per_step: List[List[Any]],
        spec: Any,
        pads: Optional[List[int]],
    ) -> Any:
        """Run one tenant's epoch program on its row (on a pod bank, the
        owning processes only); the new row for :meth:`_write_back`."""
        rows = list(leaves_per_step)
        step_pads = list(pads) if pads is not None else None
        if step_pads is not None:
            # whole no-op steps: zero inputs and pad == bucket, so the
            # correction subtracts the entire padded batch
            batched = _bucketing.batched_leaf_indices(rows[0])
            bucket = int(rows[0][batched[0]].shape[0])
            zero_row = [torch.zeros_like(x) if isinstance(x, torch.Tensor) else x for x in rows[0]]
            for _ in range(_bucketing.next_pow2(len(rows)) - len(rows)):
                rows.append(zero_row)
                step_pads.append(bucket)
        args, kwargs = _tree.unflatten(spec, self._stack(rows))
        idx = _index([self._local_row(slot)], self._device)
        inputs: Tuple[Any, ...] = (idx, len(rows), args, kwargs)
        variant = "scan"
        if step_pads is not None:
            variant += "_pad"
            inputs += (_index(step_pads, self._device),)
        out = self._run(entry, stats, variant, inputs)
        return idx, {n: v.unsqueeze(0) for n, v in out.items()}

    # ------------------------------------------------------------------
    # per-tenant results
    # ------------------------------------------------------------------
    def tenant_state(self, tenant: Hashable) -> Dict[str, Any]:
        """A copy of the tenant's state (decoded for a spilled tenant); on a
        pod bank the global state on every process (a collective)."""
        with self._lock:
            if tenant in self._spilled:
                return self._decode_spilled(tenant)[0]
            if tenant in self._slots:
                return self._row_copy(self._slots[tenant])
            raise KeyError(f"unknown tenant {tenant!r} in bank {self.name!r}")

    def update_count(self, tenant: Hashable) -> int:
        with self._lock:
            if tenant in self._counts:
                return self._counts[tenant]
            if tenant in self._spilled:
                return self._durable_counts.get(tenant, 0)
            raise KeyError(f"unknown tenant {tenant!r} in bank {self.name!r}")

    def _compute_state(self, state: Dict[str, Any]) -> Any:
        from metrics_tpu_torch.utils.data import _squeeze_if_scalar

        if self._is_collection:
            values = self._template.compute_state(self._nest(state))
            return {k: _squeeze_if_scalar(v) for k, v in values.items()}
        return _squeeze_if_scalar(self._template.compute_state(state))

    def compute(self, tenant: Hashable) -> Any:
        """The tenant's value, as ``compute()`` of a solo instance holding its
        state (a ``{member: value}`` dict for a collection bank)."""
        state = self.tenant_state(tenant)
        with self._lock:
            return self._compute_state(state)

    def compute_many(self, tenants: Iterable[Hashable]) -> Dict[Hashable, Any]:
        """``{tenant: value}``. On a pod bank (a collective) every resident
        tenant's row rides one read exchange (``coalesced_gathers`` + 1) and
        the spilled ones' blobs one broadcast from mesh rank 0; every
        process returns the same values."""
        tenants = list(tenants)
        if self._pod is None:
            return {t: self.compute(t) for t in tenants}
        out: Dict[Hashable, Any] = {}
        with self._lock:
            resident = [t for t in tenants if t in self._slots]
            if resident:
                self.stats["coalesced_gathers"] += 1
                gathered = {n: col.to(self._device) for n, col in self._gathered_rows([self._slots[t] for t in resident]).items()}
                for i, t in enumerate(resident):
                    out[t] = self._compute_state({n: col[i] for n, col in gathered.items()})
            unknown = [t for t in tenants if t not in out and t not in self._spilled]
            if unknown:
                raise KeyError(f"unknown tenant {unknown[0]!r} in bank {self.name!r}")
            spilled = [t for t in tenants if t not in out]
            blobs = self._read_blobs(spilled)
            for t in spilled:
                out[t] = self._compute_state(self._decode_spilled(t, blobs[t])[0])
        return {t: out[t] for t in tenants}

    def compute_async(self, tenants: Optional[Iterable[Hashable]] = None) -> Any:
        """Per-tenant values behind one coalesced copy to the host: an
        :class:`~metrics_tpu_torch.engine.AsyncResult` over ``{tenant:
        value}``. The default covers every session, resident and spilled."""
        from metrics_tpu_torch.engine.driver import AsyncResult

        if tenants is None:
            tenants = self.tenants + self.spilled_tenants
        return AsyncResult(self.compute_many(tenants), source=f"MetricBank:{self.name}")

    def materialize(self, tenant: Hashable) -> Any:
        """A standalone clone of the template bound to the tenant's state (a
        bound ``MetricCollection`` clone for a collection bank). On a pod
        bank (a collective) the members' split states come back placed on
        the mesh, each process holding its slices of the global state."""
        state = self.tenant_state(tenant)
        count = self.update_count(tenant)
        if self._is_collection:
            mc = self._template.clone()
            nested = self._nest(state)
            for k, m in mc._modules.items():
                self._bind_placed(m, nested[k], count)
            return mc
        return self._bind_placed(self._template.clone(), state, count)

    def _bind_placed(self, metric: Any, state: Dict[str, Any], count: int) -> Any:
        metric.bind_state(state, update_count=count)
        if self._pod is not None and metric.__dict__.get("_state_shardings"):
            metric.shard_states(self._mesh)
            _shard_spec.mark_global(metric)
        return metric

    def warmup(self, manifest: Optional[Any] = None) -> Dict[str, Any]:
        """Make the programs a warmup manifest recorded for banks like this
        one before the first wave: ``engine.warmup(manifest,
        templates=[self])``. A bank's graphs hold its leaves' addresses, so
        its entries warm only on the live bank: each wave and epoch program
        of the manifest is captured on this bank's leaves (its warm-up
        request runs with ``warm_up=True``: no row is written, no tenant
        admitted), and the per-instance programs of its template warm too.
        The first wave of a warmed signature then captures nothing (it runs
        eagerly as the cell's probe); the later ones replay. Returns
        ``engine.warmup_report()``."""
        from metrics_tpu_torch import engine as _engine

        return _engine.warmup(manifest, templates=[self])

    # ------------------------------------------------------------------
    # distributed: the whole bank over a mesh axis
    # ------------------------------------------------------------------
    def sync_state_in_trace(self, axis_name: Any, hierarchical: bool = False, *, mesh: Optional[Any] = None) -> None:
        """Reduce the whole bank across mesh axes, in place: valid when every
        process assigns the same tenants to the same slots (replicated
        serving). The tenant axis rides the per-leaf collectives
        (``parallel/comm.sync_bank_states``); the mesh is the bank's, else
        ``comm.axis_env``'s, unless given. On a tenant-sharded bank the
        reduction runs among the processes that hold the same shard, and
        naming a tenant axis raises; so does naming an axis that a member
        state is split over (its processes hold different slices)."""
        from metrics_tpu_torch.parallel import comm

        asked = {axis_name} if isinstance(axis_name, str) else set(axis_name)
        for n, axes in self._state_axes.items():
            if axes & asked:
                raise ValueError(
                    f"sync_state_in_trace: state {n!r} is split over {sorted(axes & asked)}; its processes hold"
                    " different slices of it, so an elementwise reduction over that axis would add different"
                    " slices together. Reduce over the mesh axes whose processes hold the same slice."
                )
        with self._lock:
            synced = comm.sync_bank_states(
                self._bank,
                self._reductions_ns,
                axis_name,
                hierarchical=hierarchical,
                mesh=mesh if mesh is not None else self._mesh,
                tenant_axes=self._tenant_axes,
            )
            for n, leaf in self._bank.items():
                leaf.copy_(synced[n])

    # ------------------------------------------------------------------
    # ops surface
    # ------------------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        """Occupancy, eviction and launch counters, and the screening totals
        summed over every tenant's health counters (resident and spilled).
        On a pod bank the totals ride the read exchange, so ``summary()``
        (and ``obs.snapshot()``, the Prometheus dump) is a collective of
        every process of the mesh; it is the same on every process."""
        with self._lock:
            out: Dict[str, Any] = {
                "template": type(self._template).__name__,
                "capacity": self.capacity,
                "tenant_shards": self._n_shards,
                "shard_capacity": self.shard_capacity,
                "occupancy": len(self._slots),
                "spilled": len(self._spilled),
                "store": type(self._store).__name__,
                "store_persistent": self._store.persistent,
                "dirty_tenants": len(self._dirty),
                "flush_ms_ewma": round(self._flush_ms_ewma, 3) if self._flush_ms_ewma is not None else None,
                "checkpoint_lag": self.checkpoint_lag(),
                **self.stats,
            }
            if self._n_shards > 1:
                occ = [0] * self._n_shards
                for slot in self._slots.values():
                    occ[self._slot_shard(slot)] += 1
                out["shard_occupancy"] = occ
            requests = self.stats["requests"]
            out["launch_amortization"] = round(requests / self.stats["launches"], 3) if self.stats["launches"] else None
            health_names = [n for n in self._bank if n.split("::")[-1] == _health.HEALTH_STATE]
            occupied = sorted(self._slots.values())
            counts_dev = None
            spilled_health = self._spilled_health.copy()
            if health_names and occupied:
                rows = self._gathered_rows(occupied, health_names)
                counts_dev = sum(rows[n].sum(0) for n in health_names)
        if health_names:
            # the copy to the host happens outside the lock
            counts = spilled_health
            if counts_dev is not None:
                counts = counts + counts_dev.cpu().numpy().astype(np.int64)
            out["nan_count"] = int(counts[_health.SLOT_NAN])
            out["inf_count"] = int(counts[_health.SLOT_INF])
            out["rows_masked"] = int(counts[_health.SLOT_MASKED])
            out["updates_quarantined"] = int(counts[_health.SLOT_QUARANTINED])
            out["quarantine_rate"] = round(out["updates_quarantined"] / requests, 6) if requests else 0.0
        return out

    def __repr__(self) -> str:
        return (
            f"MetricBank(name={self.name!r}, template={type(self._template).__name__},"
            f" occupancy={len(self._slots)}/{self.capacity}, spilled={len(self._spilled)})"
        )

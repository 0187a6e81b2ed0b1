"""Request-id dedup: exactly-once apply for hedged/replayed requests
(counterpart of ``metrics_tpu/serving/dedup.py``, plain Python, copied with
its caps and eviction order).

A gray-failure-immune request plane re-issues work: the
:class:`~metrics_tpu_torch.fleet.FleetGuard` hedges a stalled request toward the
tenant's rendezvous failover owner, and the fleet's kill-recovery path
re-submits a dead router's un-flushed queue. Both can race — the SAME
logical update arriving at a bank twice, through two routers — and a metric
accumulation applied twice is silently wrong forever.

:class:`RequestDedup` is the registry that makes re-issue safe: every
request carries an optional ``request_id``, and a
:class:`~metrics_tpu_torch.serving.MetricBank` wired with a shared registry
claims each ``(tenant, request_id)`` before dispatching and commits it
after the launch succeeds. The second copy — whichever router it arrived
through — is dropped *before* any state is touched (in particular, before
the bank would admit a fresh session for the tenant), and counted. The
three-phase protocol (``begin`` / ``commit`` / ``abort``) keeps a FAILED
dispatch retryable: a flush that raises aborts its claims, so the router's
re-queued requests can apply on the next attempt.

The registry is intentionally small and bounded on BOTH axes: per tenant
it remembers the last ``per_tenant_cap`` applied ids (serving traffic
hedges within a window of seconds; an id older than thousands of requests
has no live twin left to dedup against), and across tenants it keeps at
most ``max_tenants`` memories, evicting the least-recently-applied tenant
wholesale — a fleet serving millions of churning tenants must not leak a
dict entry per tenant ever seen. Dropping a memory only ever risks a
duplicate being *counted as fresh*, which the ``duplicates_applied``
counter, the exactly-once proof, would expose.
"""
import threading
from collections import deque
from typing import Any, Deque, Dict, Hashable, Set, Tuple

__all__ = ["RequestDedup"]


class RequestDedup:
    """Fleet-scoped exactly-once registry for tagged requests.

    One instance is shared by every bank a request can be re-issued to
    (:class:`~metrics_tpu_torch.fleet.Fleet` creates one and hands it to each
    worker's bank). Untagged requests (``request_id=None``) bypass it
    entirely — the legacy single-submission path pays nothing.
    """

    def __init__(self, per_tenant_cap: int = 4096, max_tenants: int = 65536) -> None:
        self.per_tenant_cap = int(per_tenant_cap)
        self.max_tenants = int(max_tenants)
        self._lock = threading.Lock()
        # tenant -> (applied-id set, insertion-ordered ring for eviction);
        # the dict itself is LRU-ordered by last commit (bounded, see above)
        self._applied: Dict[Hashable, Tuple[Set[Any], Deque[Any]]] = {}
        # (tenant, rid) -> bank name, while an apply is in flight
        self._pending: Dict[Tuple[Hashable, Any], str] = {}
        self.stats: Dict[str, int] = {
            "claims": 0,
            "applied": 0,
            "duplicates_dropped": 0,
            "duplicates_applied": 0,
            "aborts": 0,
        }

    # -- the three-phase apply protocol ---------------------------------
    def begin(self, tenant: Hashable, request_id: Any, owner: str = "") -> bool:
        """Claim ``(tenant, request_id)`` for an apply about to dispatch.

        ``True``: the caller holds the claim and MUST later :meth:`commit`
        (on success) or :meth:`abort` (on failure). ``False``: a twin of
        this request was already applied — or is being applied right now by
        another bank — and the caller must drop its copy without touching
        state (counted in ``duplicates_dropped``)."""
        key = (tenant, request_id)
        with self._lock:
            entry = self._applied.get(tenant)
            if (entry is not None and request_id in entry[0]) or key in self._pending:
                self.stats["duplicates_dropped"] += 1
                return False
            self._pending[key] = owner
            self.stats["claims"] += 1
            return True

    def commit(self, tenant: Hashable, request_id: Any) -> None:
        """Mark a claimed request applied (call after the launch succeeded)."""
        key = (tenant, request_id)
        with self._lock:
            self._pending.pop(key, None)
            entry = self._applied.pop(tenant, None)  # re-insert: LRU order
            if entry is None:
                entry = (set(), deque())
            self._applied[tenant] = entry
            ids, order = entry
            if request_id in ids:
                # a second application slipped through the claim — this is
                # the counter the exactly-once CI gate pins at zero
                self.stats["duplicates_applied"] += 1
                return
            ids.add(request_id)
            order.append(request_id)
            self.stats["applied"] += 1
            while len(order) > self.per_tenant_cap:
                ids.discard(order.popleft())
            while len(self._applied) > self.max_tenants:
                # least-recently-applied tenant's memory goes wholesale: its
                # hedge window is long past, and a slipped duplicate would
                # surface in duplicates_applied anyway
                self._applied.pop(next(iter(self._applied)))

    def abort(self, tenant: Hashable, request_id: Any) -> None:
        """Release a claim whose dispatch failed — the request stays
        re-appliable (the router re-queued it)."""
        with self._lock:
            if self._pending.pop((tenant, request_id), None) is not None:
                self.stats["aborts"] += 1

    # -- read side -------------------------------------------------------
    def is_applied(self, tenant: Hashable, request_id: Any) -> bool:
        with self._lock:
            entry = self._applied.get(tenant)
            return entry is not None and request_id in entry[0]

    def forget_tenant(self, tenant: Hashable) -> None:
        """Drop a tenant's applied-id memory immediately (the bounded LRU
        above handles this automatically). Only safe once the session is
        gone FLEET-WIDE with no hedges or resubmissions in flight — a
        migrated tenant's memory must outlive its move, so bank-level
        evict/export paths deliberately do NOT call this."""
        with self._lock:
            self._applied.pop(tenant, None)

    def summary(self) -> Dict[str, int]:
        with self._lock:
            return {**self.stats, "tenants_tracked": len(self._applied), "in_flight": len(self._pending)}

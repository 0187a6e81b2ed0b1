"""Tenant placement: rendezvous (HRW) hashing over a versioned fleet epoch
(counterpart of ``metrics_tpu/fleet/placement.py``, plain Python, copied:
the scores, and so every owner, equal the JAX package's for every id).

The serving plane answers "apply this tenant's update in one launch";
what it never answered is "*which worker* holds this tenant". This module is
that answer, and it is deliberately coordination-free: placement is a pure
function of ``(tenant, fleet epoch)``, so ANY worker — or a stateless router
in front of the fleet — computes the same owner without asking anyone.

Highest-random-weight (rendezvous) hashing: every ``(worker, tenant)`` pair
gets a deterministic 64-bit score (BLAKE2b over the two ids — never Python's
salted ``hash``), and the tenant lives on the worker with the highest score.
The property the whole elastic layer leans on: when the fleet changes by one
worker, the *relative* scores of the surviving workers are untouched, so

* a **join** moves exactly the tenants whose top score now belongs to the
  joining worker — in expectation ``K/(n+1)`` of ``K`` tenants, never a
  reshuffle of the survivors among themselves;
* a **leave** moves exactly the departing worker's tenants — ``K/n`` in
  expectation — and every one of them lands on its *second-highest* scorer,
  which is again a pure function any peer computes.

:func:`placement_diff` returns exactly that move set, and
:func:`assert_minimal_moves` turns the property into an assertion.

Epochs are versioned (:class:`FleetEpoch`): a membership change is a NEW
epoch with ``version + 1``, so "who owns tenant T at epoch E" is a stable,
cacheable fact — in-flight work tagged with an old epoch is detectably stale
instead of silently misrouted.
"""
import functools
import hashlib
from dataclasses import dataclass
from typing import Dict, Hashable, Iterable, List, Optional, Tuple

__all__ = [
    "FleetEpoch",
    "assert_minimal_moves",
    "owner",
    "owners",
    "partition_by_owner",
    "placement_diff",
    "rendezvous_score",
]


def _id_bytes(value: Hashable) -> bytes:
    """Stable byte form of a worker/tenant id. Type-prefixed so ``1`` and
    ``"1"`` cannot collide (a placement collision would silently merge two
    sessions)."""
    if isinstance(value, bytes):
        return b"b:" + value
    if isinstance(value, str):
        return b"s:" + value.encode("utf-8")
    if isinstance(value, bool):  # before int: bool is an int subclass
        return b"o:" + (b"1" if value else b"0")
    if isinstance(value, int):
        return b"i:" + str(value).encode("ascii")
    return b"r:" + repr(value).encode("utf-8")


def rendezvous_score(worker: Hashable, tenant: Hashable) -> int:
    """Deterministic 64-bit HRW score for one ``(worker, tenant)`` pair.

    BLAKE2b (8-byte digest) over the length-framed pair — process-, platform-
    and run-independent, unlike Python's per-process-salted ``hash``. Every
    peer in the fleet computes identical scores, which is what makes routing
    coordination-free.
    """
    w, t = _id_bytes(worker), _id_bytes(tenant)
    h = hashlib.blake2b(digest_size=8)
    h.update(len(w).to_bytes(4, "big"))
    h.update(w)
    h.update(t)
    return int.from_bytes(h.digest(), "big")


@dataclass(frozen=True)
class FleetEpoch:
    """An immutable, versioned fleet membership snapshot.

    ``workers`` is kept sorted/deduplicated (by stable byte id) so two peers
    that learned the membership in different orders still agree on the epoch.
    Membership changes mint a NEW epoch with ``version + 1`` — placement
    questions are always asked "at epoch E", never "right now".
    """

    version: int
    workers: Tuple[Hashable, ...]

    def __init__(self, workers: Iterable[Hashable], version: int = 0) -> None:
        cleaned = sorted(set(workers), key=_id_bytes)
        object.__setattr__(self, "version", int(version))
        object.__setattr__(self, "workers", tuple(cleaned))

    @property
    def size(self) -> int:
        return len(self.workers)

    def __contains__(self, worker: Hashable) -> bool:
        return worker in self.workers

    def with_workers(self, workers: Iterable[Hashable]) -> "FleetEpoch":
        """The next epoch holding exactly ``workers`` (version + 1)."""
        return FleetEpoch(workers, version=self.version + 1)

    def join(self, *workers: Hashable) -> "FleetEpoch":
        return self.with_workers(tuple(self.workers) + workers)

    def leave(self, *workers: Hashable) -> "FleetEpoch":
        gone = set(workers)
        missing = sorted(gone - set(self.workers), key=_id_bytes)
        if missing:
            raise KeyError(f"workers {missing} are not members of epoch v{self.version}")
        return self.with_workers(w for w in self.workers if w not in gone)

    def __repr__(self) -> str:
        return f"FleetEpoch(v{self.version}, workers={list(self.workers)})"


def owners(tenant: Hashable, epoch: FleetEpoch, k: int = 1) -> List[Hashable]:
    """The top-``k`` workers for ``tenant`` at ``epoch``, best first.

    ``k=1`` is the owner; ``k=2`` adds the worker the tenant falls to if the
    owner leaves — the failover target is as deterministic as the placement.
    Score ties (astronomically unlikely at 64 bits) break by worker id, so
    the order is total on every peer.
    """
    if not epoch.workers:
        raise ValueError(f"epoch v{epoch.version} has no workers; cannot place tenant {tenant!r}")
    ranked = sorted(
        epoch.workers,
        key=lambda w: (rendezvous_score(w, tenant), _id_bytes(w)),
        reverse=True,
    )
    return ranked[: max(1, int(k))]


@functools.lru_cache(maxsize=65536, typed=True)
def _owner_cached(tenant: Hashable, epoch: FleetEpoch) -> Hashable:
    # O(W) max, no sort — and memoized: placement is a pure function of
    # (tenant, epoch), this sits on the per-request submit path, and epochs
    # only change at resize, so the cache needs no explicit invalidation.
    # typed: True == 1 as a dict key, but the ids score apart (``_id_bytes``)
    if not epoch.workers:
        raise ValueError(f"epoch v{epoch.version} has no workers; cannot place tenant {tenant!r}")
    return max(epoch.workers, key=lambda w: (rendezvous_score(w, tenant), _id_bytes(w)))


def owner(tenant: Hashable, epoch: FleetEpoch) -> Hashable:
    """The worker owning ``tenant`` at ``epoch`` — any peer computes the
    same answer with no coordination."""
    return _owner_cached(tenant, epoch)


def placement_diff(
    tenants: Iterable[Hashable], old: FleetEpoch, new: FleetEpoch
) -> Dict[Hashable, Tuple[Hashable, Hashable]]:
    """``{tenant: (old_owner, new_owner)}`` for exactly the tenants whose
    owner changes between the two epochs — the fleet's migration work list.
    Tenants whose owner is stable are absent."""
    moves: Dict[Hashable, Tuple[Hashable, Hashable]] = {}
    for tenant in tenants:
        src, dst = owner(tenant, old), owner(tenant, new)
        if src != dst:
            moves[tenant] = (src, dst)
    return moves


def assert_minimal_moves(
    moves: Dict[Hashable, Tuple[Hashable, Hashable]],
    old: FleetEpoch,
    new: FleetEpoch,
    n_tenants: Optional[int] = None,
    slack: float = 2.5,
) -> None:
    """Raise ``AssertionError`` unless ``moves`` has the rendezvous shape.

    Exact, deterministic property: every move either *lands on* a joining
    worker or *departs from* a leaving worker — surviving workers never trade
    tenants among themselves. Statistical bound (when ``n_tenants`` is
    given): at most ``slack * n_tenants * changed/max(n)`` tenants move,
    where ``changed`` is the number of joined+left workers — the "only
    ~K/n tenants move per fleet-size change" contract, with head-room for
    hash variance. The fleet tests call this after every resize.
    """
    joined = set(new.workers) - set(old.workers)
    left = set(old.workers) - set(new.workers)
    for tenant, (src, dst) in moves.items():
        if dst not in joined and src not in left:
            raise AssertionError(
                f"non-minimal rebalance: tenant {tenant!r} moved {src!r} -> {dst!r},"
                f" but neither end is a membership change (joined={sorted(joined, key=_id_bytes)},"
                f" left={sorted(left, key=_id_bytes)}) — survivors must not trade tenants."
            )
    if n_tenants:
        changed = len(joined) + len(left)
        n = max(old.size, new.size, 1)
        bound = max(1.0, slack * n_tenants * changed / n)
        if len(moves) > bound:
            raise AssertionError(
                f"rebalance moved {len(moves)} of {n_tenants} tenants for"
                f" {changed} membership change(s) over {n} workers — above the"
                f" {bound:.1f} (~{slack}x K/n) bound."
            )


def partition_by_owner(
    tenants: Iterable[Hashable], epoch: FleetEpoch
) -> Dict[Hashable, List[Hashable]]:
    """``{worker: [tenants]}`` at ``epoch`` (workers with no tenants
    included, so occupancy gauges cover the whole fleet)."""
    out: Dict[Hashable, List[Hashable]] = {w: [] for w in epoch.workers}
    for tenant in tenants:
        out[owner(tenant, epoch)].append(tenant)
    return out

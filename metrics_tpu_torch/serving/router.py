"""Request router: group per-tenant updates by signature, flush in waves
(counterpart of ``metrics_tpu/serving/router.py``).

Serving traffic arrives one ``(tenant, batch)`` request at a time; the bank
amortizes programs only when requests reach it in waves. The router groups
requests by *input signature* (the argument structure and every leaf's
shape and dtype, the batch axis folded into its pow2 bucket when the bank
buckets, and a collection bank's fused signature) and flushes a group into
:meth:`MetricBank.apply_batch` when a bound trips:

* **size**: a wave reaches ``max_requests`` (clamped to the capacity);
* **deadline**: the oldest pending request has waited ``max_delay_s`` on
  the injected clock.

Two requests of one tenant cannot share a wave, so each group holds a list
of waves, flushed in arrival order: per-tenant order is kept exactly, across
groups too. A wave larger than the capacity is chunked. A failed flush puts
what was not applied back at the head of its queue (the bank released its
dedup claims). Deadlines are checked on :meth:`submit` and :meth:`poll`;
nothing flushes from a background thread.

While :func:`metrics_tpu_torch.obs.trace.active`, each flush of a group is a
``router.flush`` span, and every request whose submit was seen leaves one
``router.queue_wait_ms`` sample in ``obs.trace``: its wait on the router's
clock from :meth:`RequestRouter.submit` to the start of its wave's flush.

In front of a bank placed on a mesh (``MetricBank(mesh=)``) every process
of the mesh runs its own router and must flush the same waves: the
grouping is deterministic, but a deadline read from each process's clock
is not, so such a router takes ``max_delay_s=None`` (size flushes and
:meth:`RequestRouter.flush`) or a ``clock`` that every process reads alike.
"""
import time
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.engine import _tree
from metrics_tpu_torch.engine import bucketing as _bucketing
from metrics_tpu_torch.obs import trace as _trace
from metrics_tpu_torch.utils.exceptions import MetricsUserError

__all__ = ["RequestRouter"]


class _Wave:
    __slots__ = ("t", "reqs", "ids", "submitted")

    def __init__(self, now: float) -> None:
        self.t = now  # creation time == arrival of its oldest request
        self.reqs: Dict[Hashable, Tuple[Any, ...]] = {}
        # tenant -> request id (only for tagged requests; the id rides the
        # wave so a flush can hand it to the bank's exactly-once dedup and a
        # drain can hand it to the fleet's kill-path resubmission)
        self.ids: Dict[Hashable, Any] = {}
        # tenant -> submit time, for the requests submitted while traced
        self.submitted: Optional[Dict[Hashable, float]] = None


class _Group:
    __slots__ = ("waves", "pending")

    def __init__(self, now: float) -> None:
        self.waves: List[_Wave] = [_Wave(now)]
        self.pending = 0

    @property
    def oldest_t(self) -> float:
        # waves are created in arrival order, so the head wave holds the
        # oldest pending request — partial flushes pop it, and the deadline
        # naturally advances to the next wave's own arrival time instead of
        # restarting (a size-flushed head must not starve later waves)
        return self.waves[0].t


class RequestRouter:
    """Batched dispatch front for one :class:`~metrics_tpu_torch.serving.MetricBank`.

    Args:
        bank: the bank requests are applied to.
        max_requests: flush a signature wave when it reaches this many
            requests (default: ``min(256, bank.capacity)``; always clamped
            to capacity).
        max_delay_s: flush every wave of a signature group once its oldest
            request has waited this long (checked on ``submit``/``poll``;
            default 0.05s). ``None`` disables the deadline — size-only.
        clock: time source (injectable for deterministic tests).
    """

    def __init__(
        self,
        bank: Any,
        *,
        max_requests: Optional[int] = None,
        max_delay_s: Optional[float] = 0.05,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if getattr(bank, "_mesh", None) is not None and max_delay_s is not None and clock is time.monotonic:
            raise MetricsUserError(
                "a RequestRouter in front of a mesh-placed MetricBank must flush the same waves on every process"
                " of the mesh, and a deadline read from each process's own clock would not: pass"
                " max_delay_s=None (size flushes and flush()) or a clock every process reads alike."
            )
        self.bank = bank
        cap = bank.capacity
        self.max_requests = min(max_requests or min(256, cap), cap)
        self.max_delay_s = max_delay_s
        self._clock = clock
        self._groups: Dict[Any, _Group] = {}
        self.stats = {"submitted": 0, "flushes": 0, "deadline_flushes": 0, "size_flushes": 0}
        # per-signature counters OUTLIVE the signature's group (groups are
        # deleted when drained): a signature that only ever trickles in under
        # the deadline — the starvation pattern — keeps its history visible.
        # Bounded: past _SIG_STATS_CAP distinct signatures (a long-lived
        # worker fed unbucketed ragged shapes), new ones fold into one
        # "sig_other" bucket so the map cannot grow for the process lifetime
        self._sig_labels: Dict[Any, str] = {}
        self._sig_stats: Dict[str, Dict[str, Any]] = {}

    # ------------------------------------------------------------------
    def _signature(self, args: Tuple[Any, ...]) -> Any:
        leaves, treedef = _tree.flatten((tuple(args), {}))
        leaves = [torch.as_tensor(x) if isinstance(x, np.ndarray) else x for x in leaves]
        batched = _bucketing.batched_leaf_indices(leaves)
        # the bank decides bucketing (a collection bank buckets only when
        # EVERY member opted in — per-member probing here would split one
        # fused wave into per-member groups and launch per member)
        bucketing_on = self.bank._bucketing_active(batched)
        # fold the bank's fused-signature token in (collection banks): one
        # wave — one launch — flushes the whole collection, keyed by the
        # COLLECTION fingerprint, never by any single member's
        sig: List[Any] = [self.bank.signature_token(), treedef]
        for i, leaf in enumerate(leaves):
            if isinstance(leaf, torch.Tensor):
                shape, dtype = tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")
            else:
                shape, dtype = (), type(leaf).__name__
            if bucketing_on and i in batched:
                # the batch axis folds into its pow2 bucket: ragged sizes in
                # one bucket share a wave (the bank pads and corrects exactly)
                shape = (_bucketing.next_pow2(shape[0]),) + shape[1:]
            sig.append((shape, dtype))
        return tuple(sig)

    _SIG_STATS_CAP = 256

    def _sig_label(self, sig: Any) -> str:
        """Stable short label for one signature group (``sig0``, ``sig1``, …
        in first-seen order), with the leaf shapes/dtypes kept readable in
        the per-signature stats entry. Beyond ``_SIG_STATS_CAP`` distinct
        signatures, new ones share the ``sig_other`` bucket (bounded map;
        the first-seen signatures keep their dedicated rows)."""
        label = self._sig_labels.get(sig)
        if label is None:
            if len(self._sig_labels) >= self._SIG_STATS_CAP:
                # NOT cached in _sig_labels: the label map itself must stay
                # bounded, and the shared bucket needs no per-sig identity
                if "sig_other" not in self._sig_stats:
                    self._sig_stats["sig_other"] = {
                        "signature": f"(signatures beyond the first {self._SIG_STATS_CAP})",
                        "submitted": 0,
                        "flushed": 0,
                        "deadline_flushes": 0,
                        "size_flushes": 0,
                    }
                return "sig_other"
            label = f"sig{len(self._sig_labels)}"
            self._sig_labels[sig] = label
            desc = ";".join(f"{dtype}{list(shape)}" for shape, dtype in sig[2:])
            self._sig_stats[label] = {
                "signature": desc,
                "submitted": 0,
                "flushed": 0,
                "deadline_flushes": 0,
                "size_flushes": 0,
            }
        return label

    def submit(self, tenant: Hashable, *args: Any, request_id: Any = None) -> int:
        """Queue one update request; returns the number of requests flushed
        as a side effect (0 when the request just queued).

        ``request_id`` (optional) tags the request for exactly-once apply:
        the id travels with the request through flushes, drains, and
        kill-path resubmission, and a bank wired with a shared
        :class:`~metrics_tpu_torch.serving.RequestDedup` drops a second copy of
        the same ``(tenant, request_id)`` before touching state — the
        contract hedged submits rely on."""
        now = self._clock()
        sig = self._signature(args)
        self._sig_stats[self._sig_label(sig)]["submitted"] += 1
        flushed = 0
        # per-tenant order is global, not per-signature: a request landing in
        # a NEW signature group while the tenant still has pending requests
        # in another group must not overtake them — flush those groups first
        for other_sig, other in list(self._groups.items()):
            if other_sig != sig and any(tenant in w.reqs for w in other.waves):
                flushed += self._flush_group(other_sig, now=now)
        group = self._groups.get(sig)
        if group is None:
            group = self._groups[sig] = _Group(now)
        for wave in group.waves:
            if tenant not in wave.reqs:
                break
        else:
            wave = _Wave(now)
            group.waves.append(wave)
        wave.reqs[tenant] = args
        if request_id is not None:
            wave.ids[tenant] = request_id
        if _trace.active():
            if wave.submitted is None:
                wave.submitted = {}
            wave.submitted[tenant] = now
        group.pending += 1
        self.stats["submitted"] += 1
        if len(group.waves[0].reqs) >= self.max_requests:
            self.stats["size_flushes"] += 1
            self._sig_stats[self._sig_label(sig)]["size_flushes"] += 1
            flushed += self._flush_group(sig, waves=1, now=now)
        return flushed + self._flush_expired(now)

    def poll(self) -> int:
        """Deadline check without a new request (call from the serving
        loop's idle tick); returns requests flushed."""
        return self._flush_expired(self._clock())

    def flush(self) -> int:
        """Flush everything pending (e.g. before a compute/checkpoint
        barrier); returns requests flushed."""
        flushed = 0
        for sig in list(self._groups):
            flushed += self._flush_group(sig)
        return flushed

    @property
    def pending(self) -> int:
        return sum(g.pending for g in self._groups.values())

    def pending_detail(self) -> Dict[str, Dict[str, Any]]:
        """Per-signature queue/starvation view: live pending count and
        oldest-request wait next to the lifetime submitted / flushed /
        deadline-flush / size-flush counters — a signature whose traffic
        only ever leaves by deadline (``deadline_flushes`` high,
        ``size_flushes`` zero) is starving below the batch size, the thing
        a fleet operator tunes ``max_requests``/placement for."""
        now = self._clock()
        out: Dict[str, Dict[str, Any]] = {
            label: {**stats, "pending": 0, "oldest_wait_s": 0.0}
            for label, stats in self._sig_stats.items()
        }
        for sig, group in self._groups.items():
            # += / max: overflow signatures share the "sig_other" bucket
            entry = out[self._sig_label(sig)]
            entry["pending"] += group.pending
            if group.waves and group.pending:
                entry["oldest_wait_s"] = max(
                    entry["oldest_wait_s"], round(max(0.0, now - group.oldest_t), 6)
                )
        return out

    def drain_pending(self) -> List[Tuple[Hashable, Tuple[Any, ...], Any]]:
        """Remove and return every queued request WITHOUT applying it, as
        ``(tenant, args, request_id)`` triples (``request_id`` is ``None``
        for untagged requests) in per-tenant submission order (a tenant's
        requests all live in one group, in wave order — cross-group submits
        flush eagerly). The fleet's kill path re-routes these to the
        surviving owners — ids preserved, so a resubmitted request still
        dedups against its hedged twin; the pending counters reset with the
        queues."""
        out: List[Tuple[Hashable, Tuple[Any, ...], Any]] = []
        for sig in list(self._groups):
            group = self._groups.pop(sig)
            for wave in group.waves:
                out.extend((t, args, wave.ids.get(t)) for t, args in wave.reqs.items())
        return out

    def has_request_id(self, request_id: Any) -> bool:
        """Whether a tagged request is still queued (un-applied) here — the
        guard's "did the submission at least land in a queue" probe when a
        flush raised mid-``submit``."""
        return any(
            request_id in wave.ids.values()
            for group in self._groups.values()
            for wave in group.waves
        )

    # ------------------------------------------------------------------
    def _flush_expired(self, now: float) -> int:
        if self.max_delay_s is None:
            return 0
        flushed = 0
        for sig in list(self._groups):
            group = self._groups.get(sig)
            if group is not None and now - group.oldest_t >= self.max_delay_s:
                self.stats["deadline_flushes"] += 1
                self._sig_stats[self._sig_label(sig)]["deadline_flushes"] += 1
                flushed += self._flush_group(sig, now=now)
        return flushed

    def _flush_group(self, sig: Any, waves: Optional[int] = None, now: Optional[float] = None) -> int:
        """Flush up to ``waves`` waves of the group ``sig`` (all by default);
        ``now`` is the clock's reading that set the flush off, where one was
        taken."""
        if not _trace.active():
            return self._flush_waves(sig, waves)
        with _trace.span("router.flush", "RequestRouter"):
            return self._flush_waves(sig, waves, self._clock() if now is None else now)

    def _flush_waves(self, sig: Any, waves: Optional[int], now: Optional[float] = None) -> int:
        group = self._groups.get(sig)
        if group is None:
            return 0
        n_waves = len(group.waves) if waves is None else min(waves, len(group.waves))
        flushed = 0
        for _ in range(n_waves):
            wave = group.waves.pop(0)
            if not wave.reqs:
                continue
            if wave.submitted is not None and now is not None:
                for t_sub in wave.submitted.values():
                    _trace.sample("router.queue_wait_ms", (now - t_sub) * 1e3)
                wave.submitted = None  # a retried wave is not sampled twice
            requests = list(wave.reqs.items())
            # a wave larger than capacity cannot be one launch: chunk it
            try:
                for start in range(0, len(requests), self.bank.capacity):
                    chunk = requests[start : start + self.bank.capacity]
                    ids = [wave.ids.get(t) for t, _ in chunk]
                    if any(i is not None for i in ids):
                        applied = self.bank.apply_batch(chunk, request_ids=ids)
                    else:
                        applied = self.bank.apply_batch(chunk)
                    self.stats["flushes"] += 1
                    flushed += applied
                    # counted per chunk, not after the loop: a later chunk
                    # failing must not lose this chunk's applied requests
                    # from the per-signature flushed tally
                    self._sig_stats[self._sig_label(sig)]["flushed"] += applied
                    for tenant, _ in chunk:
                        wave.reqs.pop(tenant, None)
                        wave.ids.pop(tenant, None)
            except Exception:
                # a failed dispatch must not lose requests or corrupt the
                # pending counter: whatever was not applied goes back to the
                # head of the queue (its wave time preserved) for a retry
                # after the caller handles the error
                group.pending -= flushed
                if wave.reqs:
                    group.waves.insert(0, wave)
                raise
        group.pending -= flushed
        if not group.waves or all(not w.reqs for w in group.waves):
            del self._groups[sig]
        return flushed

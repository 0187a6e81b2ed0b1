"""Live tenant migration: drain, checkpoint-encode, publish, re-admit
(counterpart of ``metrics_tpu/fleet/migrate.py``).

A tenant's move between workers is built from pieces the serving plane
already has, composed in a fixed order:

1. **drain**: the source flushes its router so no request for the tenant is
   in flight (``RequestRouter.flush``; the fleet does this before any
   resize).
2. **checkpoint-encode**: the tenant leaves the source bank through the
   bank's own checkpoint route (``MetricBank.export_payload``): a migrating
   tenant is exactly a checkpointed metric.
3. **wire-encode**: the checkpoint tree is one self-describing payload
   (``serving.store.encode_tenant_payload``, the JAX package's bytes) whose
   per-leaf blocks ride the wire codecs (``parallel/groups._encode``,
   honouring the template's ``add_state(sync_precision=)`` tags when lossy
   handoff is opted into), sealed in the crc32 envelope every sync payload
   wears: a corrupted migration fails loudly, not by mis-binding state.
4. **publish**: the payload lands in a :class:`MigrationLedger` keyed by
   ``(epoch version, tenant)``. The source forgets the tenant only *after*
   publishing, and the destination acknowledges only *after* admission, so
   a worker dying mid-migration leaves the payload (the tenant's pre-drain
   state) for a surviving worker to re-admit.
5. **re-admit**: the new owner decodes, validates through
   ``Metric.bind_state`` (names, shapes, dtype kinds, the sharding layout)
   and imports into its bank (``MetricBank.import_tenant``).

Two ledgers: :class:`LocalLedger` (an in-process dict) and
:class:`KVLedger`, over the four-call key-value client the store sync
speaks (``parallel.groups._kv_client()``: the fault harness's simulated
client, else a ``StoreClient`` over the default ``TCPStore``, wrapped in the
``METRICS_TPU_FAULTS`` plan), so migration payloads cross the same fabric
and suffer the same injected faults (dropped, corrupted and late payloads)
as sync payloads.
"""
import threading
import time
from typing import Any, Dict, Hashable, List, Optional

from metrics_tpu_torch.parallel import groups as _groups

# the tenant-payload codec lives with the durable plane's storage (one home
# for the bytes migration, spill, restore and snapshots share); re-exported
# here as the JAX package does
from metrics_tpu_torch.serving.store import (  # noqa: F401  (re-export)
    decode_tenant_payload,
    encode_tenant_payload,
)

__all__ = [
    "KVLedger",
    "LocalLedger",
    "MigrationLedger",
    "admit_payload",
    "decode_tenant_payload",
    "encode_tenant_payload",
    "ledger_key",
    "reencode_payload",
]

_KEY_PREFIX = "mtpu-fleet"


def reencode_payload(payload: bytes, precisions: Optional[Dict[str, str]]) -> bytes:
    """Re-seal a durable payload with wire-codec ``precisions`` tags: the one
    lossy-handoff route (a graceful leave and a crash recovery give the same
    bytes when ``migration_precisions`` is opted into). Falsy ``precisions``
    returns the payload untouched."""
    if not precisions:
        return payload
    return encode_tenant_payload(decode_tenant_payload(payload), precisions)


def admit_payload(bank: Any, tenant: Hashable, payload: bytes, context: str = "") -> int:
    """Decode a migration payload and re-admit ``tenant`` into ``bank``.

    :meth:`MetricBank.import_tenant` validates the decoded tree on a template
    clone through :meth:`Metric.bind_state` (names, shapes, dtype kinds, the
    sharding-layout contract) before it stages it. Returns the payload size
    in bytes (the fleet's rebalance traffic sums these)."""
    tree = decode_tenant_payload(payload, context)
    bank.import_tenant(tenant, tree)
    return len(payload)


# ---------------------------------------------------------------------------
# migration ledgers
# ---------------------------------------------------------------------------
def _tenant_token(tenant: Hashable) -> str:
    """Type-framed tenant id for ledger keys: int 1 and str "1" are two
    sessions and must not share a key. Plain ints stay bare so the fault
    plans (which parse an int off the key tail) keep targeting them."""
    if isinstance(tenant, bool):
        return f"o:{int(tenant)}"
    if isinstance(tenant, int):
        return str(tenant)
    from metrics_tpu_torch.fleet.placement import _id_bytes

    return _id_bytes(tenant).decode("utf-8", "backslashreplace")


def ledger_key(fleet: str, epoch_version: int, tenant: Hashable) -> str:
    """Stable ledger key. The tenant id rides last (type-framed by
    :func:`_tenant_token`), as the sync keys' ``.../{epoch}/{rank}``, so the
    fault plans (which parse ``(epoch, rank)`` off the key tail) target the
    migration payloads of integer-identified tenants as they do sync
    payloads."""
    return f"{_KEY_PREFIX}/{fleet}/{epoch_version}/{_tenant_token(tenant)}"


class MigrationLedger:
    """Interface: publish / fetch / ack for in-flight migration payloads.

    The ledger owns crash-safety, not routing: a payload stays readable from
    publish until the *destination* acks (after admission), so any surviving
    worker can complete a migration whose source or destination died."""

    def publish(self, key: str, payload: bytes) -> None:
        raise NotImplementedError

    def fetch(self, key: str, timeout_s: float = 5.0) -> bytes:
        raise NotImplementedError

    def ack(self, key: str) -> None:
        raise NotImplementedError

    def pending(self) -> List[str]:
        """Keys published but not yet acked (best effort; key-value ledgers
        track only the keys this process published)."""
        raise NotImplementedError


class LocalLedger(MigrationLedger):
    """In-process ledger for a fleet in one process."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._data: Dict[str, bytes] = {}

    def publish(self, key: str, payload: bytes) -> None:
        with self._lock:
            self._data[key] = bytes(payload)

    def fetch(self, key: str, timeout_s: float = 5.0) -> bytes:
        deadline = time.monotonic() + timeout_s
        while True:
            with self._lock:
                if key in self._data:
                    return self._data[key]
            if time.monotonic() >= deadline:
                raise TimeoutError(f"DEADLINE_EXCEEDED: migration payload {key!r} never published")
            time.sleep(0.001)

    def ack(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)

    def pending(self) -> List[str]:
        with self._lock:
            return sorted(self._data)


class KVLedger(MigrationLedger):
    """Ledger over the key-value client the store sync speaks.

    ``client=None`` resolves as ``parallel/groups`` does: the thread's
    ``simulated_world`` client first, then a ``StoreClient`` over the
    initialized world's default store (wrapped in the ``METRICS_TPU_FAULTS``
    plan), so migration payloads cross the same fabric, and suffer the same
    injected faults, as sync payloads.
    """

    def __init__(self, client: Optional[Any] = None) -> None:
        self._client = client
        self._published: List[str] = []
        self._lock = threading.Lock()

    def _resolve(self) -> Any:
        if self._client is not None:
            return self._client
        return _groups._kv_client()

    def publish(self, key: str, payload: bytes) -> None:
        self._resolve().key_value_set_bytes(key, payload)
        with self._lock:
            if key not in self._published:
                self._published.append(key)

    def fetch(self, key: str, timeout_s: float = 5.0) -> bytes:
        return self._resolve().blocking_key_value_get_bytes(key, max(1, int(timeout_s * 1000)))

    def ack(self, key: str) -> None:
        try:
            self._resolve().key_value_delete(key)
        except Exception:  # noqa: BLE001 - best-effort cleanup, as the sync's
            pass
        with self._lock:
            if key in self._published:
                self._published.remove(key)

    def pending(self) -> List[str]:
        with self._lock:
            return list(self._published)

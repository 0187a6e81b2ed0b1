"""Durable spill tiers and the write-ahead tenant journal codec (counterpart
of ``metrics_tpu/serving/store.py``).

A bank spills cold tenants to a store and logs every durable write into a
per-bank journal there, so :meth:`MetricBank.recover` rebuilds every
acknowledged session after the process died.

* :class:`SpillStore`: the protocol. Two object kinds: **blobs** (sealed
  tenant-state payloads, one codec for spill, migration and crash restore)
  keyed by string, and **journals** (append-only record logs, one per bank).
* :class:`MemoryStore`: host RAM, the default; the same code route as the
  durable tiers, so every path is exercised by every test.
* :class:`DiskStore`: the durable tier. A blob is written to a temporary
  file and ``os.replace``'d (a crash mid-write leaves the previous payload);
  a journal is an append-only file of length-framed, crc32-sealed records.
  A torn tail (the frame a ``kill -9`` interrupted) is counted by
  :func:`read_journal` and truncated before the next append.
* :class:`OrbaxStore`: the JAX package's orbax tier. Orbax is a JAX
  library, and the port imports no JAX: the class keeps its name and its
  constructor raises the error the JAX class raises without orbax.

The bytes are the JAX package's: journal records are sorted JSON in the
wire envelope (``parallel/groups.pack_envelope``), payloads a JSON key
manifest and one exact wire payload per leaf, so a store written by either
package recovers in the other. Both are durable-schema families
(``resilience/schema.py``): ``journal`` v1/v2 and ``payload`` v1/v2, v1
upcast to v2. Tenant ids ride as type-framed tokens (:func:`durable_token`)
so ``1``, ``"1"`` and ``True`` stay distinct sessions.

Telemetry: :func:`durability_stats` (``obs.snapshot()["durability"]``, the
``metrics_tpu_durable_*`` families); the bank emits the ``journal``,
``spill_write`` and ``recover`` events.
"""
import json
import os
import struct
import threading
import urllib.parse
from typing import Any, Dict, Hashable, List, Optional, Tuple

import numpy as np

from metrics_tpu_torch.obs import bus as _bus
from metrics_tpu_torch.parallel import groups as _groups
from metrics_tpu_torch.resilience import integrity as _integrity
from metrics_tpu_torch.resilience import schema as _schema
from metrics_tpu_torch.utils.exceptions import MetricsUserError, SyncIntegrityError

__all__ = [
    "DiskStore",
    "MemoryStore",
    "OrbaxStore",
    "SpillStore",
    "decode_tenant_payload",
    "durability_stats",
    "durable_token",
    "encode_tenant_payload",
    "read_journal",
    "reset_durability_stats",
    "seal_record",
    "token_tenant",
    "unseal_record",
]

#: v2 carries the integrity plane's digests; v1 is the digest-less record.
JOURNAL_VERSION = 2

_STATS_LOCK = threading.Lock()


def _new_stats() -> Dict[str, int]:
    return {
        "journal_appends": 0,
        "journal_bytes": 0,
        "journal_compactions": 0,
        "records_replayed": 0,
        "torn_records": 0,
        "spill_writes": 0,
        "spill_bytes": 0,
        "blob_reads": 0,
        "checkpoints": 0,
        "recovers": 0,
        "recovered_tenants": 0,
        "snapshots": 0,
        "snapshot_bytes": 0,
        "resumes": 0,
        "torn_tails_truncated": 0,
    }


_STATS = _new_stats()


def bump(key: str, n: int = 1) -> None:
    with _STATS_LOCK:
        _STATS[key] += n


def durability_stats() -> Dict[str, int]:
    """Process-wide durable-plane counters: journal appends, bytes and
    compactions, replayed and torn records, spill blob writes, reads and
    bytes, bank checkpoints, recoveries and the tenants they restored, and
    the drive snapshots written (``snapshots``, ``snapshot_bytes``) and
    resumed (``resumes``)."""
    with _STATS_LOCK:
        return dict(_STATS)


def reset_durability_stats() -> None:
    with _STATS_LOCK:
        for key in list(_STATS):
            _STATS[key] = 0


# ---------------------------------------------------------------------------
# tenant tokens: type-framed, journal-safe, reversible
# ---------------------------------------------------------------------------
def durable_token(tenant: Hashable) -> List[Any]:
    """A JSON-safe, reversible encoding of a tenant id, type-framed so ``1``,
    ``"1"``, ``True`` and ``1.0`` stay four sessions (``bool`` is tested
    before ``int``). Ids must be ``str``/``int``/``bool``/``float``/``None``:
    recovery rebuilds the id from bytes, so another hashable is refused at
    admission instead of recovering as another session."""
    if isinstance(tenant, bool):
        return ["b", tenant]
    if isinstance(tenant, int):
        return ["i", tenant]
    if isinstance(tenant, float):
        return ["f", tenant]
    if isinstance(tenant, str):
        return ["s", tenant]
    if tenant is None:
        return ["n", None]
    raise MetricsUserError(
        f"tenant id {tenant!r} of type {type(tenant).__name__} cannot ride the"
        " durable state plane: journal records must reconstruct the id after a"
        " process crash, so ids must be str/int/bool/float/None."
    )


def token_tenant(token: Any) -> Hashable:
    """Inverse of :func:`durable_token`."""
    kind, value = token
    if kind == "b":
        return bool(value)
    if kind == "i":
        return int(value)
    if kind == "f":
        return float(value)
    if kind == "s":
        return str(value)
    if kind == "n":
        return None
    raise SyncIntegrityError(f"Unknown tenant token kind {kind!r} in journal record.")


def token_key(token: List[Any]) -> str:
    """Stable string form of a token for blob keys."""
    return urllib.parse.quote(json.dumps(token, sort_keys=True), safe="")


# ---------------------------------------------------------------------------
# journal record codec: versioned JSON in the crc32 envelope
# ---------------------------------------------------------------------------
def seal_record(record: Dict[str, Any]) -> bytes:
    """One journal record: sorted JSON with its version, in the crc32
    envelope, so a torn or flipped record fails its checksum."""
    body = dict(record)
    body.setdefault("v", JOURNAL_VERSION)
    return _groups.pack_envelope(json.dumps(body, sort_keys=True).encode("utf-8"))


def unseal_record(payload: bytes, context: str = "") -> Dict[str, Any]:
    """Decode one journal record through the schema registry: v1 records
    upcast, a record of a newer build raises :class:`SchemaVersionError`."""
    return _schema.decode_any("journal", payload, context=context)


def _journal_record_body(payload: bytes, context: str) -> Dict[str, Any]:
    _version, body = _groups.unpack_envelope(payload, context)
    try:
        record = json.loads(body.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as err:
        raise SyncIntegrityError(f"Unparseable journal record{context}: {err}") from err
    if not isinstance(record, dict):
        raise SyncIntegrityError(f"Journal record is not an object{context}.")
    return record


def _journal_version_of(payload: bytes) -> Any:
    # a record without the field probes as v1, the digest-less schema
    return _journal_record_body(payload, "").get("v", 1)


def _upcast_journal_v1(record: Dict[str, Any]) -> Dict[str, Any]:
    """v1 -> v2: an unattested record (``digest: None`` skips verification)."""
    out = dict(record)
    out.setdefault("digest", None)
    out["v"] = 2
    return out


_schema.register_schema("journal", 1, _journal_record_body, upcast=_upcast_journal_v1, prober=_journal_version_of)
_schema.register_schema("journal", 2, _journal_record_body)


def read_journal(store: "SpillStore", journal: str) -> Tuple[List[Dict[str, Any]], int]:
    """Decode a journal, stopping at the first torn or corrupted record:
    ``(records, torn)``, where ``torn`` counts the frames ignored, a
    framing-torn trailing fragment included (0 for a clean journal)."""
    records: List[Dict[str, Any]] = []
    frames, tail_torn = store.journal_scan(journal)
    torn = int(tail_torn)
    for i, frame in enumerate(frames):
        try:
            records.append(unseal_record(frame, context=f" (journal {journal!r}, record {i})"))
        except SyncIntegrityError:
            torn += len(frames) - i
            break
    if torn:
        bump("torn_records", torn)
    bump("records_replayed", len(records))
    return records, torn


# ---------------------------------------------------------------------------
# the store protocol
# ---------------------------------------------------------------------------
class SpillStore:
    """A spill tier: keyed sealed blobs and per-bank journals.

    ``persistent`` says whether the tier survives the process. Methods must
    be thread-safe, and ``put`` atomic: a crash mid-write leaves the previous
    payload readable."""

    persistent = False

    def put(self, key: str, payload: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def append_journal(self, journal: str, record: bytes) -> None:
        raise NotImplementedError

    def append_journal_many(self, journal: str, records: List[bytes]) -> None:
        """Append records in order; tiers with a cost per append (disk) make
        it one write."""
        for record in records:
            self.append_journal(journal, record)

    def journal_frames(self, journal: str) -> List[bytes]:
        """Raw record frames in append order, a framing-torn tail dropped;
        the crc is checked by :func:`read_journal`."""
        raise NotImplementedError

    def journal_torn_tail(self, journal: str) -> int:
        """1 when the journal ends in a framing-torn tail, else 0."""
        return 0

    def journal_scan(self, journal: str) -> Tuple[List[bytes], int]:
        """``(journal_frames(j), journal_torn_tail(j))`` in one pass."""
        return self.journal_frames(journal), self.journal_torn_tail(journal)

    def rewrite_journal(self, journal: str, records: List[bytes]) -> None:
        """Replace a journal's contents atomically (compaction, recovery)."""
        raise NotImplementedError


class MemoryStore(SpillStore):
    """Host-RAM tier: spilled state lives as long as the process."""

    persistent = False

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._blobs: Dict[str, bytes] = {}
        self._journals: Dict[str, List[bytes]] = {}

    def put(self, key: str, payload: bytes) -> None:
        with self._lock:
            self._blobs[key] = bytes(payload)

    def get(self, key: str) -> bytes:
        with self._lock:
            if key not in self._blobs:
                raise KeyError(f"no blob {key!r} in MemoryStore")
            return self._blobs[key]

    def delete(self, key: str) -> None:
        with self._lock:
            self._blobs.pop(key, None)

    def exists(self, key: str) -> bool:
        with self._lock:
            return key in self._blobs

    def append_journal(self, journal: str, record: bytes) -> None:
        with self._lock:
            self._journals.setdefault(journal, []).append(bytes(record))

    def journal_frames(self, journal: str) -> List[bytes]:
        with self._lock:
            return list(self._journals.get(journal, ()))

    def journal_scan(self, journal: str) -> Tuple[List[bytes], int]:
        with self._lock:
            return list(self._journals.get(journal, ())), 0

    def rewrite_journal(self, journal: str, records: List[bytes]) -> None:
        with self._lock:
            self._journals[journal] = [bytes(r) for r in records]


class DiskStore(SpillStore):
    """Durable disk tier rooted at ``root``: ``root/blobs/<quoted key>.bin``
    and ``root/journal/<quoted name>.waj``, the JAX package's layout, so
    either package reads a directory the other wrote.

    ``fsync=True`` fsyncs every blob write and journal append, and the
    directory after a rename or a journal's creation (a power loss can
    undo an ``os.replace`` whose directory entry was not synced). The
    default trusts the page cache: it survives the process's death, not the
    host's."""

    persistent = True

    def __init__(self, root: str, *, fsync: bool = False) -> None:
        self.root = os.path.abspath(root)
        self.fsync = bool(fsync)
        self._blob_dir = os.path.join(self.root, "blobs")
        self._journal_dir = os.path.join(self.root, "journal")
        os.makedirs(self._blob_dir, exist_ok=True)
        os.makedirs(self._journal_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._tmp_ids = 0
        # journals this handle appended to or rewrote: their tails are
        # frame-clean, so appends skip the torn-tail scan
        self._append_clean: set = set()

    def _blob_path(self, key: str) -> str:
        return os.path.join(self._blob_dir, urllib.parse.quote(key, safe="") + ".bin")

    def _journal_path(self, journal: str) -> str:
        return os.path.join(self._journal_dir, urllib.parse.quote(journal, safe="") + ".waj")

    def _write_atomic(self, path: str, payload: bytes) -> None:
        with self._lock:
            self._tmp_ids += 1
            tmp = f"{path}.tmp{os.getpid()}.{self._tmp_ids}"
        with open(tmp, "wb") as f:
            f.write(payload)
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if self.fsync:
            self._fsync_dir(os.path.dirname(path))

    @staticmethod
    def _fsync_dir(path: str) -> None:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def put(self, key: str, payload: bytes) -> None:
        self._write_atomic(self._blob_path(key), bytes(payload))

    def get(self, key: str) -> bytes:
        try:
            with open(self._blob_path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise KeyError(f"no blob {key!r} in DiskStore({self.root!r})") from None

    def delete(self, key: str) -> None:
        try:
            os.remove(self._blob_path(key))
        except FileNotFoundError:
            pass

    def exists(self, key: str) -> bool:
        return os.path.exists(self._blob_path(key))

    def append_journal(self, journal: str, record: bytes) -> None:
        self.append_journal_many(journal, [record])

    def append_journal_many(self, journal: str, records: List[bytes]) -> None:
        if not records:
            return
        body = b"".join(struct.pack(">I", len(r)) + bytes(r) for r in records)
        path = self._journal_path(journal)
        with self._lock:
            created = not os.path.exists(path)
            # appending after a torn tail would bury these records inside the
            # phantom frame the crash left: the first append of this handle
            # truncates it
            if not created and journal not in self._append_clean:
                self._truncate_torn_tail(path)
            self._append_clean.add(journal)
            with open(path, "ab") as f:
                f.write(body)
                if self.fsync:
                    f.flush()
                    os.fsync(f.fileno())
            if self.fsync and created:
                self._fsync_dir(self._journal_dir)

    @staticmethod
    def _scan_frames(data: bytes) -> Tuple[List[bytes], int]:
        """``(frames, valid_bytes)``: bytes past ``valid_bytes`` are a
        framing-torn tail."""
        frames: List[bytes] = []
        offset = 0
        while offset + 4 <= len(data):
            (size,) = struct.unpack(">I", data[offset : offset + 4])
            if offset + 4 + size > len(data):
                break
            frames.append(data[offset + 4 : offset + 4 + size])
            offset += 4 + size
        return frames, offset

    def _truncate_torn_tail(self, path: str) -> None:
        try:
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return
        _frames, valid = self._scan_frames(data)
        if valid < len(data):
            bump("torn_tails_truncated")
            with open(path, "r+b") as f:
                f.truncate(valid)
                if self.fsync:
                    f.flush()
                    os.fsync(f.fileno())

    def _read_journal_bytes(self, journal: str) -> bytes:
        try:
            with open(self._journal_path(journal), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return b""

    def journal_frames(self, journal: str) -> List[bytes]:
        return self._scan_frames(self._read_journal_bytes(journal))[0]

    def journal_torn_tail(self, journal: str) -> int:
        return self.journal_scan(journal)[1]

    def journal_scan(self, journal: str) -> Tuple[List[bytes], int]:
        data = self._read_journal_bytes(journal)
        frames, valid = self._scan_frames(data)
        return frames, (1 if valid < len(data) else 0)

    def rewrite_journal(self, journal: str, records: List[bytes]) -> None:
        body = b"".join(struct.pack(">I", len(r)) + bytes(r) for r in records)
        self._write_atomic(self._journal_path(journal), body)
        with self._lock:
            self._append_clean.add(journal)


class OrbaxStore(SpillStore):
    """The JAX package's orbax-backed tier. Orbax checkpoints JAX pytrees
    and the port imports no JAX, so this tier is not available here: the
    constructor raises the error the JAX class raises without orbax, and
    :class:`DiskStore` is the port's durable tier (the same payload bytes
    and the same journal framing)."""

    persistent = True

    def __init__(self, root: str, *, fsync: bool = False) -> None:
        raise MetricsUserError(
            "OrbaxStore needs the optional `orbax-checkpoint` package"
            " (pip install orbax-checkpoint); use DiskStore for a"
            " dependency-free durable tier."
        )


# ---------------------------------------------------------------------------
# journal replay: the recovery source
# ---------------------------------------------------------------------------
def tenant_blob_key(bank_name: str, token: List[Any]) -> str:
    """One blob per (bank, tenant), overwritten at each checkpoint or spill:
    the journal is an index, not a log of states."""
    return f"tenant/{urllib.parse.quote(bank_name, safe='')}/{token_key(token)}"


def replay_journal(store: SpillStore, bank_name: str) -> Tuple[Dict[Hashable, Dict[str, Any]], int]:
    """Replay ``bank_name``'s journal into ``{tenant: {"count", "health",
    "digest"}}`` for every session admitted or imported and not dropped or
    exported; unknown ops are skipped. Returns ``(live, torn_records)``."""
    records, torn = read_journal(store, bank_name)
    live: Dict[Hashable, Dict[str, Any]] = {}
    for rec in records:
        op = rec.get("op")
        if "t" not in rec:
            continue
        try:
            tenant = token_tenant(rec["t"])
        except (SyncIntegrityError, TypeError, ValueError):
            continue
        if op == "admit":
            live.setdefault(tenant, {"count": 0, "health": None, "digest": None})
        elif op in ("spill", "checkpoint", "import"):
            live[tenant] = {"count": int(rec.get("count", 0)), "health": rec.get("health"), "digest": rec.get("digest")}
        elif op in ("drop", "export"):
            live.pop(tenant, None)
        # "recover", "audit" and later kinds: replay-neutral
    return live, torn


def durable_tenant_payloads(
    store: SpillStore, bank_name: str, live: Optional[Dict[Hashable, Dict[str, Any]]] = None
) -> Dict[Hashable, Tuple[bytes, int]]:
    """Every live tenant's latest sealed payload and update count; a tenant
    whose blob is missing (a crash between the admit record and the defaults
    blob) never had acknowledged state and is skipped. ``live`` (a
    :func:`replay_journal` result) skips the replay."""
    if live is None:
        live, _torn = replay_journal(store, bank_name)
    out: Dict[Hashable, Tuple[bytes, int]] = {}
    for tenant, rec in live.items():
        try:
            payload = store.get(tenant_blob_key(bank_name, durable_token(tenant)))
        except KeyError:
            continue
        bump("blob_reads")
        out[tenant] = (payload, int(rec.get("count", 0)))
    return out


def journal_drop(store: SpillStore, bank_name: str, tenant: Hashable) -> None:
    """Journal that ``tenant`` left ``bank_name`` and delete its blob, for a
    namespace no live bank owns (a dead worker's)."""
    token = durable_token(tenant)
    record = seal_record({"op": "drop", "t": token})
    store.append_journal(bank_name, record)
    bump("journal_appends")
    bump("journal_bytes", len(record))
    store.delete(tenant_blob_key(bank_name, token))
    if _bus.enabled():
        _bus.emit("journal", bank=bank_name, op="drop", tenant=str(tenant))


# ---------------------------------------------------------------------------
# tenant-payload codec: one checkpoint tree <-> one sealed payload
# ---------------------------------------------------------------------------
#: v2 attests every exact leaf with its digest; v1 is the digest-less header.
_PAYLOAD_VERSION = 2


def encode_tenant_payload(
    tree: Dict[str, Any], precisions: Optional[Dict[str, str]] = None, stats: Optional[Dict[str, Any]] = None
) -> bytes:
    """Seal one checkpoint tree (``metric_state_pytree`` output, numpy or
    CPU tensor leaves) as a self-describing payload: the envelope around a
    JSON header (``v``, sorted ``keys``, the ``digest`` of every exact leaf)
    and one length-framed wire payload per leaf (exact v1, or quantized v2
    for a leaf named in ``precisions``). The JAX package's bytes."""
    keys = sorted(tree)
    blocks: List[bytes] = []
    digests: Dict[str, str] = {}
    for key in keys:
        value = tree[key]
        if isinstance(value, dict):
            raise MetricsUserError(
                f"migration payloads cannot carry list ('cat' buffer) state {key!r} — banks reject"
                " list-state templates, so a banked tenant never holds one. Migrate such metrics by"
                " checkpoint file instead."
            )
        host = np.asarray(value) if not hasattr(value, "detach") else value
        block, codec = _groups._encode_with_codec(host, (precisions or {}).get(key), stats=stats)
        blocks.append(block)
        if codec == "exact":
            digests[key] = _integrity.leaf_digest(host)
    if digests:
        _integrity.bump("attests_recorded")
    header = json.dumps({"v": _PAYLOAD_VERSION, "keys": keys, "digest": digests}).encode()
    body = struct.pack(">I", len(header)) + header
    body += b"".join(struct.pack(">Q", len(b)) + b for b in blocks)
    return _groups.pack_envelope(body)


def decode_tenant_payload(payload: bytes, context: str = "") -> Dict[str, Any]:
    """Inverse of :func:`encode_tenant_payload` (CPU tensor leaves). A broken
    envelope or frame raises :class:`SyncIntegrityError`; an attested leaf
    whose bytes fold to another digest raises
    :class:`~metrics_tpu_torch.utils.exceptions.StateIntegrityError` naming
    the leaf; a payload of a newer build raises :class:`SchemaVersionError`."""
    return _schema.decode_any("payload", payload, context=context)


def _payload_header(payload: bytes, context: str) -> Dict[str, Any]:
    _version, body = _groups.unpack_envelope(payload, context)
    if len(body) < 4:
        raise SyncIntegrityError(f"Truncated migration payload: no header length{context}.")
    (header_len,) = struct.unpack(">I", body[:4])
    if 4 + header_len > len(body):
        raise SyncIntegrityError(
            f"Truncated migration payload{context}: header claims {header_len}"
            f" bytes, only {len(body) - 4} present."
        )
    try:
        header = json.loads(body[4 : 4 + header_len].decode())
        header["keys"] = list(header["keys"])
    except (ValueError, KeyError, TypeError, UnicodeDecodeError) as err:
        raise SyncIntegrityError(f"Unparseable migration payload header{context}: {err}") from err
    header["_body"] = body
    header["_offset"] = 4 + header_len
    return header


def _payload_version_of(payload: bytes) -> Any:
    return _payload_header(payload, "").get("v")


def _decode_payload_blocks(payload: bytes, context: str, verify: bool) -> Dict[str, Any]:
    header = _payload_header(payload, context)
    body = header["_body"]
    offset = header["_offset"]
    tree: Dict[str, Any] = {}
    for key in header["keys"]:
        if offset + 8 > len(body):
            raise SyncIntegrityError(f"Truncated migration payload at block {key!r}{context}.")
        (size,) = struct.unpack(">Q", body[offset : offset + 8])
        offset += 8
        if offset + size > len(body):
            raise SyncIntegrityError(
                f"Truncated migration payload{context}: block {key!r} declares"
                f" {size} bytes, only {len(body) - offset} remain."
            )
        tree[key] = _groups._decode(body[offset : offset + size], context)
        offset += size
    expected = header.get("digest")
    if verify and expected:
        _integrity.verify_tree(tree, expected, context=context)
    return tree


def _decode_payload_v1(payload: bytes, context: str) -> Dict[str, Any]:
    return _decode_payload_blocks(payload, context, verify=False)


def _decode_payload_v2(payload: bytes, context: str) -> Dict[str, Any]:
    return _decode_payload_blocks(payload, context, verify=True)


def _upcast_payload_v1(tree: Dict[str, Any]) -> Dict[str, Any]:
    """v1 -> v2: the state tree is the same; the digests are transport."""
    return tree


_schema.register_schema("payload", 1, _decode_payload_v1, upcast=_upcast_payload_v1, prober=_payload_version_of)
_schema.register_schema("payload", 2, _decode_payload_v2)

"""Process subgroups over a ``torch.distributed`` key-value ``Store``
(counterpart of ``metrics_tpu/parallel/groups.py``).

A :class:`ProcessGroup` is a plain record of member ranks: it pickles with
its ranks, where a ``torch.distributed`` group handle belongs to the
process that made it. Its members sync through the world's key-value store,
not through a collective, so that every exchange can be bounded, retried and
degraded. Every member

1. publishes its payload under a per-call key
   (``metrics_tpu/pg/{scope}/{epoch}/{rank}``),
2. reads the other members' keys, with retry and backoff in rounds,
3. joins a subset barrier over the group's ranks, so that nobody deletes a
   key a peer has not read yet, then
4. deletes its own key.

Only members touch these keys; processes outside the group are neither
blocked nor contacted. Payloads carry their own dtype and shape, so ragged
per-rank buffers need no pad-to-max. The key layout, the epochs, the
envelope and the payload bytes are the JAX package's, so a JAX peer and a
port peer can share one store.

The store is reached through the JAX package's four-call client protocol
(``resilience/faults.py``): on a ``torch.distributed`` world a
:class:`StoreClient` adapts the default group's ``Store`` to it; under the
fault harness the thread's simulated client stands in.

Groups must be created in the same order with the same ranks on every
member, as with ``torch.distributed.new_group``: per-group call counters key
the exchanges, and they stay aligned only when the members issue the same
sequence of grouped syncs.

Hardening (``docs/fault_tolerance.md`` of the JAX package): payloads ride a
versioned crc32 envelope; peer reads retry with deadline-budgeted backoff
under the group's :class:`~metrics_tpu_torch.resilience.RetryPolicy`, all
inside one deadline (``timeout_s``); ``policy="partial"`` returns the
members that delivered instead of raising. Before the payload round the
members advertise the wire versions they speak and settle on the highest
common one (:func:`speaking` pins a thread's versions, to simulate an old
build).
"""
import contextlib
import contextvars
import itertools
import json
import struct
import threading
import time
import zlib
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from metrics_tpu_torch.obs import bus as _obs_bus
from metrics_tpu_torch.parallel import quantize as _quant
from metrics_tpu_torch.resilience import faults as _faults
from metrics_tpu_torch.resilience import new_sync_stats
from metrics_tpu_torch.resilience.retry import DEFAULT_RETRY, RetryPolicy
from metrics_tpu_torch.utils.exceptions import MetricsUserError, SyncError, SyncIntegrityError, SyncTimeoutError

_KV_PREFIX = "metrics_tpu/pg"

# Versioned wire envelope: magic, format version, crc32 of the body.
# v1 (WIRE_VERSION): exact payloads, a length-prefixed JSON header (dtype,
# shape) and the raw bytes; every exact state ships v1. v2
# (WIRE_VERSION_QUANTIZED): quantized payloads, whose header also names the
# codec (and the int8 block size). A version outside the accepted set raises
# a non-transient SyncIntegrityError: re-reading a payload of another build
# can never succeed.
_WIRE_MAGIC = b"MT"
WIRE_VERSION = 1
WIRE_VERSION_QUANTIZED = 2
SUPPORTED_WIRE_VERSIONS = (WIRE_VERSION, WIRE_VERSION_QUANTIZED)
_ENVELOPE = struct.Struct(">2sBI")

# a thread's override of the wire versions it advertises (``speaking``)
_SPOKEN_OVERRIDE: "contextvars.ContextVar[Optional[Tuple[int, ...]]]" = contextvars.ContextVar(
    "metrics_tpu_torch_spoken_wire_versions", default=None
)

_NEGO_LOCK = threading.Lock()


def _new_nego_stats() -> Dict[str, int]:
    return {
        "negotiations": 0,  # completed advertisement rounds
        "capped": 0,  # rounds that settled below this process's highest version
        "fallback_exact": 0,  # quantized tags sent exact under a v1 cap
    }


_NEGO_STATS = _new_nego_stats()


def spoken_wire_versions() -> Tuple[int, ...]:
    """The wire versions this thread advertises (a subset of
    :data:`SUPPORTED_WIRE_VERSIONS`, narrowed by :func:`speaking`)."""
    override = _SPOKEN_OVERRIDE.get()
    return override if override is not None else SUPPORTED_WIRE_VERSIONS


@contextlib.contextmanager
def speaking(*versions: int):
    """Pin the wire versions this thread advertises: ``with speaking(1):``
    makes every exchange on the thread negotiate as a v1-only peer (an old
    build in a fleet that is half upgraded)."""
    cleaned = tuple(sorted({int(v) for v in versions}))
    if not cleaned or any(v not in SUPPORTED_WIRE_VERSIONS for v in cleaned):
        raise ValueError(f"speaking() needs a non-empty subset of {SUPPORTED_WIRE_VERSIONS}, got {versions!r}.")
    token = _SPOKEN_OVERRIDE.set(cleaned)
    try:
        yield
    finally:
        _SPOKEN_OVERRIDE.reset(token)


def negotiation_stats() -> Dict[str, int]:
    """Process-wide negotiation counters: rounds completed, rounds settled
    below this build's highest version, and quantized exchanges sent exact
    under a v1 cap."""
    with _NEGO_LOCK:
        return dict(_NEGO_STATS)


def reset_negotiation_stats() -> None:
    with _NEGO_LOCK:
        for key in list(_NEGO_STATS):
            _NEGO_STATS[key] = 0


def _bump_nego(key: str, n: int = 1) -> None:
    with _NEGO_LOCK:
        _NEGO_STATS[key] += n


# per-group call counters; aligned across processes by the same-order contract
_call_counters: Dict[str, "itertools.count"] = {}


def _next_epoch(scope: str) -> int:
    """Next exchange epoch of ``scope``. Each simulated rank of the fault
    harness keeps its own counter, as each process does in a real world."""
    sim = _faults.simulated_process()
    key = scope if sim is None else f"{scope}#sim{sim[0]}"
    return next(_call_counters.setdefault(key, itertools.count()))


class ProcessGroup:
    """A named set of process ranks to sync a metric over.

    Pass as ``Metric(process_group=...)`` (or to
    ``comm.gather_all_arrays``) to sync the states of ``compute()`` among
    the member processes only, through the store. ``ranks`` are
    ``torch.distributed`` ranks of the default group.

    Args:
        ranks: member ranks; deduplicated and sorted.
        name: a stable identifier; processes that sync together use equal
            names. Defaults to a name derived from ``ranks``.
        timeout_s: the total deadline of one exchange (reads, backoff pauses
            and the closing barrier all fit inside it).
        retry: the :class:`~metrics_tpu_torch.resilience.RetryPolicy` for
            transient failures inside one exchange; not part of the group's
            identity.
    """

    def __init__(
        self,
        ranks: Sequence[int],
        name: Optional[str] = None,
        timeout_s: float = 120.0,
        retry: Optional[RetryPolicy] = None,
    ) -> None:
        cleaned = sorted({int(r) for r in ranks})
        if not cleaned:
            raise ValueError("A ProcessGroup needs at least one member rank.")
        if cleaned[0] < 0:
            raise ValueError(f"Process ranks must be non-negative, got {cleaned}.")
        self.ranks = tuple(cleaned)
        self.name = name if name is not None else "r" + "_".join(str(r) for r in cleaned)
        self.timeout_s = float(timeout_s)
        self.retry = retry if retry is not None else DEFAULT_RETRY

    @property
    def size(self) -> int:
        return len(self.ranks)

    def __contains__(self, rank: int) -> bool:
        return int(rank) in self.ranks

    def __repr__(self) -> str:
        return f"ProcessGroup(name={self.name!r}, ranks={list(self.ranks)})"

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, ProcessGroup) and (self.name, self.ranks) == (other.name, other.ranks)

    def __hash__(self) -> int:
        return hash((self.name, self.ranks))

    @property
    def _kv_scope(self) -> str:
        # identity is (name, ranks): two groups sharing a name but not
        # members must not share a key and epoch namespace
        return f"{self.name}:{'-'.join(str(r) for r in self.ranks)}"


def new_group(
    ranks: Sequence[int],
    name: Optional[str] = None,
    timeout_s: float = 120.0,
    retry: Optional[RetryPolicy] = None,
) -> ProcessGroup:
    """Create a :class:`ProcessGroup`, as ``torch.distributed.new_group`` makes a group."""
    return ProcessGroup(ranks, name=name, timeout_s=timeout_s, retry=retry)


# ---------------------------------------------------------------------------
# the store client
# ---------------------------------------------------------------------------
# a value no payload can have (payloads start with the magic "MT"): the
# expected value of the non-blocking read below
_ABSENT = b"\x00metrics_tpu_torch:absent"


# the errors a torch.distributed store raises on a timeout or a lost connection
_STORE_ERRORS: Tuple[type, ...] = tuple(
    t for t in (getattr(dist, "DistStoreError", None), getattr(dist, "DistNetworkError", None)) if t
)


class StoreClient:
    """The four-call client protocol over a ``torch.distributed`` ``Store``.

    * ``blocking_key_value_get_bytes`` waits for the key with
      ``store.wait([key], timeout)`` on the attempt's budget, then reads it
      with a ``compare_set`` that never blocks: a ``get`` would wait for the
      store's own timeout on a key deleted in between (a peer that cleaned
      up), where this raises a timeout at once.
    * ``wait_at_barrier`` is a subset barrier the store does not have: each
      member sets ``{barrier_id}/{rank}`` and waits for every member's key.
      A member's arrival key stays until it passes a later barrier of the
      same scope (every member has then left the earlier one), so no member
      deletes a key that a slower peer may still be waiting on; at most one
      or two arrival keys per member and scope remain.
    """

    def __init__(self, store: Any, rank: int, world: int) -> None:
        self._store = store
        self.rank = int(rank)
        self.world = int(world)
        self._arrivals: Dict[str, List[str]] = {}
        self._lock = threading.Lock()

    @property
    def store(self) -> Any:
        return self._store

    def key_value_set_bytes(self, key: str, value: bytes) -> None:
        self._store.set(key, bytes(value))

    def blocking_key_value_get_bytes(self, key: str, timeout_ms: int) -> bytes:
        try:
            self._store.wait([key], timedelta(milliseconds=max(1, int(timeout_ms))))
        except _STORE_ERRORS as err:
            raise _faults.KVTimeoutError(f"DEADLINE_EXCEEDED: key {key!r} not available within {timeout_ms}ms: {err}") from err
        value = self._store.compare_set(key, _ABSENT, _ABSENT)
        if bytes(value) == _ABSENT:
            raise _faults.KVTimeoutError(f"DEADLINE_EXCEEDED: key {key!r} was deleted before it could be read")
        return bytes(value)

    def wait_at_barrier(self, barrier_id: str, timeout_ms: int, process_ids: Optional[Sequence[int]] = None) -> None:
        ids = sorted({int(p) for p in process_ids}) if process_ids else list(range(self.world))
        own = f"{barrier_id}/{self.rank}"
        scope = barrier_id.rsplit("/", 2)[0]
        self._store.set(own, b"1")
        keys = [f"{barrier_id}/{p}" for p in ids]
        try:
            self._store.wait(keys, timedelta(milliseconds=max(1, int(timeout_ms))))
        except _STORE_ERRORS as err:
            with self._lock:
                self._arrivals.setdefault(scope, []).append(own)
            missing = [p for p, k in zip(ids, keys) if not self._store.check([k])]
            raise _faults.KVTimeoutError(
                f"DEADLINE_EXCEEDED: barrier {barrier_id!r} missing ranks {missing} after {timeout_ms}ms"
            ) from err
        with self._lock:
            stale = self._arrivals.get(scope, [])
            self._arrivals[scope] = [own]
        for key in stale:
            try:
                self._store.delete_key(key)
            except Exception:  # noqa: BLE001, S110 - cleanup is best effort, as the payload delete's
                pass

    def key_value_delete(self, key: str) -> None:
        self._store.delete_key(key)


def _default_store() -> Any:
    """The default group's ``Store`` (private API of ``torch.distributed``:
    ``distributed_c10d._get_default_store``)."""
    from torch.distributed import distributed_c10d

    getter = getattr(distributed_c10d, "_get_default_store", None)
    if getter is None:
        raise RuntimeError(
            "ProcessGroup sync reads the default group's store through"
            " torch.distributed.distributed_c10d._get_default_store, which this torch build lacks."
        )
    return getter()


_world_client: Dict[str, Any] = {}


def _kv_client():
    """The thread's simulated client (the fault harness), else a
    :class:`StoreClient` over the initialized world's store, wrapped in the
    ``METRICS_TPU_FAULTS`` plan when one is set."""
    override = _faults.current_client()
    if override is not None:
        return override
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "ProcessGroup sync needs an initialized torch.distributed world: call"
            " torch.distributed.init_process_group(...) before the first grouped compute()."
        )
    world = dist.group.WORLD
    cached = _world_client.get("client")
    if cached is None or _world_client.get("world") is not world:
        cached = StoreClient(_default_store(), dist.get_rank(), dist.get_world_size())
        _world_client.update(client=cached, world=world)
    return _faults.maybe_wrap_client(cached)


# ---------------------------------------------------------------------------
# the envelope and the payloads
# ---------------------------------------------------------------------------
def pack_envelope(body: bytes, version: int = WIRE_VERSION) -> bytes:
    """Wrap ``body`` in the versioned envelope: magic, version, crc32(body)."""
    if version not in SUPPORTED_WIRE_VERSIONS:
        raise ValueError(f"Cannot seal a payload as wire v{version}; this build speaks {SUPPORTED_WIRE_VERSIONS}.")
    return _ENVELOPE.pack(_WIRE_MAGIC, version, zlib.crc32(body)) + body


def unpack_envelope(payload: bytes, context: str = "", accept: Optional[Sequence[int]] = None) -> "tuple[int, bytes]":
    """Validate the envelope and return ``(version, body)``.

    ``accept`` narrows the admissible versions (default: every version this
    build speaks). Raises :class:`SyncIntegrityError`: transient for
    truncation and corruption (a re-read may see a clean write), not
    transient for a foreign magic or a version outside ``accept``."""
    accepted = tuple(accept) if accept is not None else SUPPORTED_WIRE_VERSIONS
    if len(payload) < _ENVELOPE.size:
        raise SyncIntegrityError(
            f"Truncated sync payload: {len(payload)} bytes is smaller than the"
            f" {_ENVELOPE.size}-byte wire envelope{context}."
        )
    magic, version, crc = _ENVELOPE.unpack(payload[: _ENVELOPE.size])
    if magic != _WIRE_MAGIC:
        raise SyncIntegrityError(
            f"Sync payload does not carry the metrics_tpu wire magic{context}: the peer runs an"
            " incompatible build, or something else wrote to this key.",
            transient=False,
        )
    if version not in accepted:
        speaks = "/".join(f"v{v}" for v in accepted)
        raise SyncIntegrityError(
            f"Sync wire-format version mismatch{context}: peer sent v{version},"
            f" this process speaks {speaks}. All members of a ProcessGroup must"
            " run compatible wire versions (quantized payloads are v2; exact payloads are v1).",
            transient=False,
        )
    body = payload[_ENVELOPE.size :]
    actual = zlib.crc32(body)
    if actual != crc:
        raise SyncIntegrityError(
            f"Corrupted sync payload{context}: crc32 {actual:#010x} != declared {crc:#010x} over {len(body)} body bytes."
        )
    return version, body


def _seal(body: bytes, version: int = WIRE_VERSION) -> bytes:
    return pack_envelope(body, version)


def _open_envelope(payload: bytes, context: str = "", accept: Optional[Sequence[int]] = None) -> bytes:
    return unpack_envelope(payload, context, accept)[1]


def _raw_bytes(t: torch.Tensor) -> bytes:
    """A contiguous CPU tensor's bytes (bfloat16 through its int16 bits)."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _from_bytes(data: bytes, dtype: torch.dtype, shape: Tuple[int, ...]) -> torch.Tensor:
    """A CPU tensor of ``dtype`` and ``shape`` over a copy of ``data``."""
    np_dtype = np.int16 if dtype == torch.bfloat16 else np.dtype(_quant.dtype_name(dtype))
    arr = np.frombuffer(data, dtype=np_dtype).copy()
    t = torch.from_numpy(arr)
    if dtype == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.reshape(shape)


def _host_tensor(x: Any) -> torch.Tensor:
    t = _quant.as_tensor(x).detach()
    if t.device.type != "cpu":
        t = t.cpu()
    return t.contiguous()


def _encode_with_codec(x: Any, precision: Optional[str] = None, stats: Optional[Dict[str, Any]] = None) -> "tuple[bytes, str]":
    """Encode one array; returns ``(payload, resolved codec)``.

    Exact payloads seal as wire v1, the JAX package's bytes; quantized ones
    as wire v2, the codec (and the int8 block) in the header and the scales
    and codes in the body. The wire counters (raw and encoded bytes, codec
    counts, round-trip error) accumulate into ``stats`` (a sync report) and
    :func:`~metrics_tpu_torch.parallel.quantize.wire_stats`."""
    t = _host_tensor(x)
    codec = _quant.resolve_codec(precision, t.dtype)
    name = _quant.dtype_name(t.dtype)
    shape = [int(d) for d in t.shape]
    if codec == "exact":
        header = json.dumps({"dtype": name, "shape": shape}).encode()
        raw = _raw_bytes(t)
        _quant.record_wire("exact", len(raw), len(raw), stats=stats)
        return _seal(struct.pack(">I", len(header)) + header + raw), codec
    qdata, scales, meta = _quant.quantize_array(t, codec)
    decoded = _quant.dequantize_array(qdata, scales, codec, t.dtype, tuple(shape))
    error = 0.0
    if t.numel():
        diff = (t.to(torch.float64) - decoded.to(torch.float64)).abs()
        finite = diff[torch.isfinite(diff)]  # NaN and ±Inf inputs: no error defined there
        error = float(finite.max()) if finite.numel() else 0.0
    header = json.dumps({"dtype": name, "shape": shape, **meta}).encode()
    scale_bytes = _raw_bytes(scales.contiguous()) if scales is not None else b""
    code_bytes = _raw_bytes(qdata.contiguous())
    encoded_nbytes = len(code_bytes) + len(scale_bytes)
    raw_nbytes = _quant.nbytes(t)
    _quant.record_wire(codec, raw_nbytes, encoded_nbytes, error=error, stats=stats)
    if _obs_bus.enabled():
        _obs_bus.emit(
            "wire", source="kv", codec=codec, bytes_raw=raw_nbytes, bytes_encoded=encoded_nbytes, max_dequant_error=error
        )
    return _seal(struct.pack(">I", len(header)) + header + scale_bytes + code_bytes, WIRE_VERSION_QUANTIZED), codec


def _encode(x: Any, precision: Optional[str] = None, stats: Optional[Dict[str, Any]] = None) -> bytes:
    return _encode_with_codec(x, precision, stats)[0]


def _decode(payload: bytes, context: str = "", accept: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Decode one payload to a CPU tensor of its declared dtype and shape."""
    version, body = unpack_envelope(payload, context, accept)
    if len(body) < 4:
        raise SyncIntegrityError(f"Truncated sync payload: no header length{context}.")
    (header_len,) = struct.unpack(">I", body[:4])
    if 4 + header_len > len(body):
        raise SyncIntegrityError(
            f"Truncated sync payload{context}: header claims {header_len} bytes, only {len(body) - 4} present."
        )
    try:
        header = json.loads(body[4 : 4 + header_len].decode())
        dtype_name, shape = header["dtype"], tuple(int(d) for d in header["shape"])
    except (ValueError, KeyError, TypeError, UnicodeDecodeError) as err:
        raise SyncIntegrityError(f"Unparseable sync payload header{context}: {err}") from err
    try:
        dtype = _quant.torch_dtype(dtype_name)
    except TypeError as err:
        raise SyncIntegrityError(f"Sync payload names dtype {dtype_name!r}{context}, which this build cannot hold.", transient=False) from err
    data = body[4 + header_len :]
    codec = header.get("codec", "exact")
    n_elems = int(np.prod(shape, dtype=np.int64)) if shape else 1
    # the envelope version and the header's codec must agree
    if (version == WIRE_VERSION) != (codec == "exact"):
        raise SyncIntegrityError(
            f"Sync wire-format version mismatch{context}: envelope v{version} with codec {codec!r}:"
            f" v{WIRE_VERSION} payloads are exact-only, v{WIRE_VERSION_QUANTIZED} payloads must name their codec.",
            transient=False,
        )
    itemsize = torch.empty((), dtype=dtype).element_size()
    if codec == "exact":
        expected = itemsize * n_elems
        if len(data) != expected:
            raise SyncIntegrityError(
                f"Sync payload length mismatch{context}: header declares dtype={dtype_name} shape={list(shape)}"
                f" ({expected} bytes), payload carries {len(data)}."
            )
        return _from_bytes(data, dtype, shape)
    if codec == "bf16":
        qdtype, scale_bytes = torch.bfloat16, 0
    elif codec == "int8":
        block = int(header.get("block", _quant.INT8_BLOCK))
        if block != _quant.INT8_BLOCK:
            raise SyncIntegrityError(
                f"Sync payload uses int8 block size {block}{context}; this build speaks block size {_quant.INT8_BLOCK}.",
                transient=False,
            )
        qdtype = torch.int8
        scale_bytes = (-(-n_elems // block) if n_elems else 0) * 4
    else:
        raise SyncIntegrityError(
            f"Sync payload names unknown wire codec {codec!r}{context}; this build speaks {_quant.CODECS}.",
            transient=False,
        )
    expected = scale_bytes + (2 if qdtype == torch.bfloat16 else 1) * n_elems
    if len(data) != expected:
        raise SyncIntegrityError(
            f"Sync payload length mismatch{context}: header declares codec={codec} dtype={dtype_name}"
            f" shape={list(shape)} ({expected} bytes), payload carries {len(data)}."
        )
    scales = _from_bytes(data[:scale_bytes], torch.float32, (scale_bytes // 4,)) if scale_bytes else None
    qdata = _from_bytes(data[scale_bytes:], qdtype, (n_elems,))
    return _quant.dequantize_array(qdata, scales, codec, dtype, shape)


# ---------------------------------------------------------------------------
# the exchange
# ---------------------------------------------------------------------------
_DESYNC_HINT = (
    " All members must issue grouped syncs in the same order and count: a peer"
    " that is behind (another call order) or ahead (restarted, epoch counter"
    " reset) publishes under another epoch key and can never meet this one."
)


def _is_transient_kv_error(err: BaseException) -> bool:
    """Transient means worth another attempt within the deadline: a store
    timeout (``DistStoreError``), a socket-level failure
    (``TimeoutError``, ``ConnectionError``, ``OSError``, and so
    ``InjectedFaultError``), a retryable integrity failure, or an error whose
    message says it timed out or was unavailable."""
    if isinstance(err, SyncIntegrityError):
        return err.transient
    if isinstance(err, (TimeoutError, ConnectionError, OSError) + _STORE_ERRORS):
        return True
    msg = str(err).lower()
    return any(s in msg for s in ("deadline_exceeded", "deadline exceeded", "timed out", "timeout", "unavailable"))


def _read_peers_with_retry(
    client: Any,
    group: ProcessGroup,
    scope: str,
    epoch: int,
    rank: int,
    read_deadline: float,
    policy: str,
    stats: Dict[str, Any],
) -> Dict[int, bytes]:
    """Every peer's payload, read in rounds (attempt 1 for every peer, then
    attempt 2 for those that failed, ...) inside the read deadline, so a dead
    peer cannot starve the reads of live ones. The keys (and the epoch) stay
    the same across attempts, so a slow peer can still meet the exchange;
    each read is envelope-checked, and a transient integrity failure costs
    one attempt. Exhaustion raises :class:`SyncTimeoutError` unless
    ``policy="partial"``, which leaves the peer out."""
    retry = group.retry
    peers = [m for m in group.ranks if m != rank]
    results: Dict[int, bytes] = {}
    last_err: Dict[int, BaseException] = {}
    tries: Dict[int, int] = {m: 0 for m in peers}
    outstanding = list(peers)
    for attempt in range(1, retry.max_attempts + 1):
        attempts_left = retry.max_attempts - attempt + 1
        failed_this_round: List[int] = []
        for position, member in enumerate(outstanding):
            remaining = read_deadline - time.monotonic()
            if remaining <= 0:
                failed_this_round.extend(outstanding[position:])
                break
            key = f"{_KV_PREFIX}/{scope}/{epoch}/{member}"
            context = f" (group={group.name!r}, epoch={epoch}, peer rank={member}, this rank={rank})"
            # what is left of the deadline over every read that may still
            # happen: the rest of this round, times the rounds left
            budget_s = retry.attempt_timeout_s(remaining, attempts_left * (len(outstanding) - position))
            budget_s = min(budget_s, remaining)
            stats["attempts"] += 1
            tries[member] += 1
            if tries[member] > 1:
                stats["retries"] += 1
            if _obs_bus.enabled():
                _obs_bus.emit(
                    "sync_retry" if tries[member] > 1 else "sync_attempt",
                    source=f"group:{group.name}",
                    epoch=epoch,
                    peer=member,
                    rank=rank,
                    attempt=tries[member],
                    budget_s=round(budget_s, 4),
                )
            try:
                raw = client.blocking_key_value_get_bytes(key, max(1, int(budget_s * 1000)))
                _open_envelope(raw, context)  # corruption is classified (and retried) here
            except SyncIntegrityError as err:
                stats["integrity_failures"] += 1
                if not err.transient:
                    raise
                last_err[member] = err
                failed_this_round.append(member)
            except Exception as err:  # noqa: BLE001 - classified right below
                if not _is_transient_kv_error(err):
                    raise SyncError(f"KV read failed{context}: {err}") from err
                stats["kv_timeouts"] += 1
                last_err[member] = err
                failed_this_round.append(member)
            else:
                stats["bytes_received"] += len(raw)
                results[member] = raw
        outstanding = failed_this_round
        if not outstanding:
            break
        if attempt < retry.max_attempts:
            pause = retry.backoff_s(attempt, key=(scope, epoch, rank))
            pause = min(pause, max(0.0, read_deadline - time.monotonic()))
            if pause > 0:
                stats["backoff_s"] += pause
                time.sleep(pause)
    if outstanding and policy != "partial":
        member = outstanding[0]
        raise SyncTimeoutError(
            f"Gave up on a peer's sync payload after {tries[member]} attempt(s)"
            f" (group={group.name!r}, epoch={epoch}, peer rank={member}, this"
            f" rank={rank}), group deadline {group.timeout_s}s.{_DESYNC_HINT}"
            f" Last error: {last_err.get(member)}"
        ) from last_err.get(member)
    return results


def _exchange_bytes(
    payload: bytes,
    group: ProcessGroup,
    rank: int,
    policy: str = "raise",
    report: Optional[Dict[str, Any]] = None,
) -> List[Optional[bytes]]:
    """One publish, read-all and barrier round among the members; the
    members' payloads in ``group.ranks`` order (None for a member missing
    under ``policy="partial"``, its rank in ``report["missing_ranks"]``).

    One deadline (``group.timeout_s``) bounds it all, and a slice of it is
    kept for the closing barrier. The member's own key is deleted even when
    a read or the barrier fails."""
    client = _kv_client()
    scope = group._kv_scope
    epoch = _next_epoch(scope)
    stats = report if report is not None else new_sync_stats()
    deadline = time.monotonic() + group.timeout_s
    # a slice for the barrier (it clears in microseconds once every member has read)
    read_deadline = deadline - min(1.0, 0.1 * group.timeout_s) if group.size > 1 else deadline
    context = f" (group={group.name!r}, scope={scope!r}, epoch={epoch}, rank={rank})"

    own_key = f"{_KV_PREFIX}/{scope}/{epoch}/{rank}"
    try:
        client.key_value_set_bytes(own_key, payload)
    except Exception as err:  # noqa: BLE001 - a failed publish is a failed sync
        raise SyncError(f"KV publish failed{context}: {err}") from err
    stats["bytes_sent"] += len(payload)
    try:
        results = _read_peers_with_retry(client, group, scope, epoch, rank, read_deadline, policy, stats)
        barrier_ms = max(1, int((deadline - time.monotonic()) * 1000))
        try:
            client.wait_at_barrier(f"{_KV_PREFIX}/{scope}/{epoch}/done", barrier_ms, process_ids=list(group.ranks))
        except Exception as err:  # noqa: BLE001 - classified below
            stats["barrier_timeouts"] += 1
            if _obs_bus.enabled():
                _obs_bus.emit(
                    "sync_degrade",
                    source=f"group:{group.name}",
                    policy=policy,
                    outcome="barrier_timeout",
                    epoch=epoch,
                    rank=rank,
                )
            if policy != "partial" or not _is_transient_kv_error(err):
                raise SyncTimeoutError(
                    f"Group barrier failed{context} within the {group.timeout_s}s deadline.{_DESYNC_HINT}"
                    f" Original error: {err}"
                ) from err
            # degraded: peers that read our key are unaffected; a straggler
            # that reads after the delete times out under its own policy
    finally:
        try:
            client.key_value_delete(own_key)
        except Exception:  # noqa: BLE001, S110 - best effort: never mask the primary error
            pass
    stats["missing_ranks"] = [m for m in group.ranks if m != rank and m not in results]
    return [payload if m == rank else results.get(m) for m in group.ranks]


def _membership_or_raise(group: ProcessGroup) -> Optional[int]:
    """This process's rank in ``group``; None in a world of one process."""
    sim = _faults.simulated_process()
    if sim is not None:
        rank, world = sim
        if rank not in group:
            raise ValueError(
                f"Simulated process {rank} is not a member of {group!r}; grouped sync must only run on member processes."
            )
        if group.ranks[-1] >= world:
            raise ValueError(f"{group!r} names rank {group.ranks[-1]} but the simulated world has only {world} processes.")
        return rank
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if world == 1:
        if group.ranks != (0,):
            raise ValueError(
                f"{group!r} names ranks beyond the single running process; start"
                " torch.distributed (init_process_group) to sync over subgroups."
            )
        return None
    rank = dist.get_rank()
    if rank not in group:
        raise ValueError(
            f"Process {rank} is not a member of {group!r}; grouped sync must only run on member"
            " processes (create the metric with a group holding this rank, or skip compute() here)."
        )
    if group.ranks[-1] >= world:
        raise ValueError(f"{group!r} names rank {group.ranks[-1]} but only {world} processes are running.")
    return rank


def _negotiate_wire_version(group: ProcessGroup, rank: int, policy: str = "raise") -> int:
    """Advertise this member's wire versions under
    ``{prefix}/{scope}/speaks/{rank}`` and settle on the highest version
    every member speaks.

    The advertisement keys lie outside the ``{epoch}/{rank}`` shape that a
    fault plan targets, so injected faults hit the payload exchange, not the
    handshake. They are small, re-published before each exchange and never
    deleted. A v1-only member caps the group at v1, and quantized tags then
    travel exact; an empty intersection is a non-transient
    :class:`SyncIntegrityError`. Under ``policy="partial"`` a peer that
    never advertises is left out (its payload read degrades the same way).
    Negotiation reads stay out of the sync report's counters
    (:func:`negotiation_stats` counts the rounds)."""
    spoken = spoken_wire_versions()
    if group.size == 1:
        return max(spoken)
    client = _kv_client()
    scope = group._kv_scope
    own_key = f"{_KV_PREFIX}/{scope}/speaks/{rank}"
    context = f" (group={group.name!r}, scope={scope!r}, rank={rank})"
    try:
        client.key_value_set_bytes(own_key, ",".join(str(v) for v in spoken).encode())
    except Exception as err:  # noqa: BLE001 - a failed publish is a failed sync
        raise SyncError(f"KV version advertisement failed{context}: {err}") from err
    deadline = time.monotonic() + group.timeout_s
    common = set(spoken)
    for member in group.ranks:
        if member == rank:
            continue
        key = f"{_KV_PREFIX}/{scope}/speaks/{member}"
        raw: Optional[bytes] = None
        last_err: Optional[BaseException] = None
        while raw is None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                if policy == "partial":
                    break
                raise SyncTimeoutError(
                    f"Peer rank {member} never advertised its wire versions{context} within the"
                    f" {group.timeout_s}s deadline.{_DESYNC_HINT} Last error: {last_err}"
                ) from last_err
            try:
                raw = client.blocking_key_value_get_bytes(key, max(1, int(min(remaining, 2.0) * 1000)))
            except Exception as err:  # noqa: BLE001 - classified below
                if not _is_transient_kv_error(err):
                    raise SyncError(f"KV version-advertisement read failed{context}: {err}") from err
                last_err = err
        if raw is None:
            continue
        try:
            peer_spoken = {int(v) for v in raw.decode("ascii").split(",")}
        except (ValueError, UnicodeDecodeError) as err:
            raise SyncIntegrityError(
                f"Unparseable wire-version advertisement from peer rank {member}{context}: {raw!r}.", transient=False
            ) from err
        common &= peer_spoken
    if not common:
        raise SyncIntegrityError(
            f"No common wire version{context}: this member speaks {sorted(spoken)}, the group's"
            " intersection is empty. Builds this far apart cannot interoperate.",
            transient=False,
        )
    negotiated = max(common)
    _bump_nego("negotiations")
    if negotiated < max(spoken):
        _bump_nego("capped")
        if _obs_bus.enabled():
            _obs_bus.emit(
                "compat",
                event="wire_negotiated",
                source=f"group:{group.name}",
                rank=rank,
                negotiated=negotiated,
                spoken=list(spoken),
            )
    return negotiated


def _accepted_versions(cap: int) -> Tuple[int, ...]:
    return tuple(v for v in SUPPORTED_WIRE_VERSIONS if v <= cap)


def gather_group_arrays(
    x: Any,
    group: ProcessGroup,
    policy: str = "raise",
    report: Optional[Dict[str, Any]] = None,
    precision: Optional[str] = None,
) -> List[torch.Tensor]:
    """Every member's ``x``, in ``group.ranks`` order, on ``x``'s device.

    Every member (and only members) must call it. Under
    ``policy="partial"`` the list holds only the members that delivered
    within the deadline (the missing ranks in ``report["missing_ranks"]``).
    ``precision`` picks the wire codec: exact ships wire v1; ``"bf16"`` and
    ``"int8"`` send float payloads as wire v2 (integer and bool payloads
    stay exact)."""
    rank = _membership_or_raise(group)
    if rank is None:
        return [_quant.as_tensor(x)]
    cap = _negotiate_wire_version(group, rank, policy=policy)
    if precision is not None and cap < WIRE_VERSION_QUANTIZED:
        _bump_nego("fallback_exact")
        precision = None
    accept = _accepted_versions(cap)
    device = x.device if isinstance(x, torch.Tensor) else torch.device("cpu")
    payloads = _exchange_bytes(_encode(x, precision, stats=report), group, rank, policy=policy, report=report)
    return [
        _decode(p, context=f" (group={group.name!r}, peer rank={member})", accept=accept).to(device)
        for member, p in zip(group.ranks, payloads)
        if p is not None
    ]


# ---------------------------------------------------------------------------
# state trees: dicts, lists, tuples and None over tensor leaves
# ---------------------------------------------------------------------------
_LEAF = ("leaf",)


def _flatten(tree: Any, leaves: Optional[List[Any]] = None) -> Tuple[List[Any], Any]:
    """``(leaves, spec)``: leaves in the JAX package's ``tree_flatten`` order
    (dict keys sorted)."""
    out: List[Any] = [] if leaves is None else leaves
    if tree is None:
        spec: Any = ("none",)
    elif isinstance(tree, dict):
        spec = ("dict", tuple((k, _flatten(tree[k], out)[1]) for k in sorted(tree)))
    elif isinstance(tree, (list, tuple)):
        spec = (type(tree).__name__, tuple(_flatten(v, out)[1] for v in tree))
    else:
        out.append(tree)
        spec = _LEAF
    return out, spec


def _unflatten(spec: Any, leaves: Any) -> Any:
    it = iter(leaves)

    def build(node: Any) -> Any:
        kind = node[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(child) for k, child in node[1]}
        children = [build(child) for child in node[1]]
        return children if kind == "list" else tuple(children)

    return build(spec)


def _spec_str(node: Any) -> str:
    kind = node[0]
    if kind == "leaf":
        return "*"
    if kind == "none":
        return "None"
    if kind == "dict":
        return "{" + ", ".join(f"{k!r}: {_spec_str(c)}" for k, c in node[1]) + "}"
    inner = ", ".join(_spec_str(c) for c in node[1])
    if kind == "list":
        return f"[{inner}]"
    return f"({inner},)" if len(node[1]) == 1 else f"({inner})"


def _tree_signature(spec: Any) -> int:
    """The structure fingerprint shipped with a tree payload: the crc32 of
    the JAX package's ``str(treedef)`` of the same structure, so trees of
    the two packages fingerprint alike."""
    return zlib.crc32(f"PyTreeDef({_spec_str(spec)})".encode())


def _tag_slots(node: Any) -> int:
    """Leaves of ``node`` plus its None nodes: the slots the JAX package's
    tag tree flattens to (its ``is_leaf`` takes None as a leaf)."""
    if node is None:
        return 1
    if isinstance(node, dict):
        return sum(_tag_slots(v) for v in node.values())
    if isinstance(node, (list, tuple)):
        return sum(_tag_slots(v) for v in node)
    return 1


def _leaf_precisions(tree: Any, precisions: Optional[Dict[str, str]]) -> Optional[List[Optional[str]]]:
    """Per-leaf ``sync_precision`` tags in flatten order, for a tree whose
    top level maps state names; None means all exact, as it does in the JAX
    package for a tree whose tags would not line up with its leaves (a None
    inside a state)."""
    if not precisions or not isinstance(tree, dict):
        return None
    tags: List[Optional[str]] = []
    for name in sorted(tree):
        tags.extend([precisions.get(name)] * _tag_slots(tree[name]))
    if len(tags) != len(_flatten(tree)[0]):
        return None
    return tags


def _to_host(leaves: List[Any]) -> List[torch.Tensor]:
    """The leaves as contiguous CPU tensors, those on a device in one copy."""
    tensors = [_quant.as_tensor(leaf).detach() for leaf in leaves]
    on_device = [i for i, t in enumerate(tensors) if t.device.type != "cpu"]
    if on_device:
        flat = [tensors[i].contiguous().reshape(-1).view(torch.uint8) for i in on_device]
        host = torch.cat(flat).cpu() if len(flat) > 1 else flat[0].cpu()
        at = 0
        for i, part in zip(on_device, flat):
            n = part.numel()
            t = tensors[i]
            tensors[i] = host[at : at + n].clone().view(t.dtype).reshape(t.shape)
            at += n
    return [t.contiguous() for t in tensors]


_ALIGN = 16


def _to_device(trees: List[Any], device: torch.device) -> List[Any]:
    """Decoded CPU trees moved to ``device`` in one host-to-device copy."""
    if device.type == "cpu":
        return trees
    flats = [_flatten(tree) for tree in trees]
    parts = [leaf for leaves, _ in flats for leaf in leaves]
    offsets, at = [], 0
    for t in parts:
        offsets.append(at)
        at += -(-_quant.nbytes(t) // _ALIGN) * _ALIGN
    staged = torch.empty(max(at, _ALIGN), dtype=torch.uint8, pin_memory=torch.cuda.is_available())
    for t, off in zip(parts, offsets):
        n = _quant.nbytes(t)
        if n:
            staged[off : off + n] = t.contiguous().reshape(-1).view(torch.uint8)
    moved = staged.to(device, non_blocking=True)
    out, k = [], 0
    for leaves, spec in flats:
        new = []
        for t in leaves:
            n = _quant.nbytes(t)
            new.append(moved[offsets[k] : offsets[k] + n].view(t.dtype).reshape(t.shape))
            k += 1
        out.append(_unflatten(spec, new))
    return out


def _encode_tree(tree: Any, precisions: Optional[Dict[str, str]] = None, stats: Optional[Dict[str, Any]] = None) -> bytes:
    leaves, spec = _flatten(tree)
    tags = _leaf_precisions(tree, precisions) or [None] * len(leaves)
    blocks: List[bytes] = []
    any_quantized = False
    for leaf, tag in zip(_to_host(leaves), tags):
        payload, codec = _encode_with_codec(leaf, tag, stats=stats)
        any_quantized = any_quantized or codec != "exact"
        blocks.append(payload)
    header = struct.pack(">II", len(blocks), _tree_signature(spec))
    # an all-exact tree seals v1; any quantized leaf lifts the envelope to v2
    version = WIRE_VERSION_QUANTIZED if any_quantized else WIRE_VERSION
    return _seal(header + b"".join(struct.pack(">Q", len(b)) + b for b in blocks), version)


def _decode_tree(payload: bytes, spec: Any, n_leaves: int, context: str = "", accept: Optional[Sequence[int]] = None) -> Any:
    body = _open_envelope(payload, context, accept)
    if len(body) < 8:
        raise SyncIntegrityError(f"Truncated sync tree payload: no block header{context}.")
    count, sig = struct.unpack(">II", body[:8])
    if count != n_leaves or sig != _tree_signature(spec):
        raise ValueError(
            f"Group member sent a state tree with {count} leaves (structure fingerprint {sig:#010x}) but this"
            f" process holds {n_leaves} ({_tree_signature(spec):#010x}): metric states must be structurally"
            " identical across the members of a ProcessGroup."
        )
    offset, member_leaves = 8, []
    for _ in range(count):
        if offset + 8 > len(body):
            raise SyncIntegrityError(f"Truncated sync tree payload at block {len(member_leaves)}{context}.")
        (size,) = struct.unpack(">Q", body[offset : offset + 8])
        offset += 8
        if offset + size > len(body):
            raise SyncIntegrityError(
                f"Truncated sync tree payload{context}: block {len(member_leaves)} declares {size} bytes,"
                f" only {len(body) - offset} remain."
            )
        member_leaves.append(_decode(body[offset : offset + size], context, accept))
        offset += size
    return _unflatten(spec, member_leaves)


def gather_group_pytrees(
    tree: Any,
    group: ProcessGroup,
    policy: str = "raise",
    report: Optional[Dict[str, Any]] = None,
    precisions: Optional[Dict[str, str]] = None,
) -> List[Any]:
    """A whole state tree from every member in one exchange: one tree per
    member, in ``group.ranks`` order.

    The leaves go to the host in one copy and are encoded into one payload;
    the members' trees are decoded to CPU tensors and moved to the device
    of the tree's first tensor leaf in one copy. Members must hold trees of
    the same structure (leaf shapes may differ; the structure is
    fingerprinted and checked). ``policy="partial"`` leaves out the members
    that never delivered. ``precisions`` maps the top-level state names to
    ``sync_precision`` tags; tagged float leaves travel quantized (a wire v2
    envelope), the rest exact."""
    rank = _membership_or_raise(group)
    if rank is None:
        return [tree]
    cap = _negotiate_wire_version(group, rank, policy=policy)
    if precisions and cap < WIRE_VERSION_QUANTIZED:
        _bump_nego("fallback_exact")
        precisions = None
    accept = _accepted_versions(cap)
    leaves, spec = _flatten(tree)
    device = next((leaf.device for leaf in leaves if isinstance(leaf, torch.Tensor)), torch.device("cpu"))
    payload = _encode_tree(tree, precisions=precisions, stats=report)
    trees = [
        _decode_tree(member_payload, spec, len(leaves), context=f" (group={group.name!r}, peer rank={member})", accept=accept)
        for member, member_payload in zip(group.ranks, _exchange_bytes(payload, group, rank, policy=policy, report=report))
        if member_payload is not None
    ]
    return _to_device(trees, device)


_SIMPLE_REDUCTIONS = ("sum", "mean", "max", "min")


def gather_state_trees(
    tree: Any,
    group: Optional[Any],
    dist_sync_fn: Optional[Callable] = None,
    policy: str = "raise",
    report: Optional[Dict[str, Any]] = None,
    reductions: Optional[Dict[str, Any]] = None,
    sync_precisions: Optional[Dict[str, str]] = None,
) -> List[Any]:
    """A whole state tree from every sync peer; one tree per member.

    The one dispatch point of ``Metric._gather_with_policy``: a
    :class:`ProcessGroup` with the default gather takes the batched
    exchange above (the only path with per-member partial results);
    anything else (a custom ``dist_sync_fn``, a ``torch.distributed``
    group, the default world) gathers leaf by leaf and transposes the
    results into per-member trees, degrading whole-state only.

    ``reductions`` (``{state name: dist_reduce_fx}``, for a tree whose top
    level maps state names) lets the default gather skip the shape exchange
    of fixed-shape reduce states (sum/mean/max/min); the caller leaves out
    list and shape-polymorphic states. ``sync_precisions`` (``{state name:
    "bf16"|"int8"}``) picks each state's wire codec on both default paths; a
    custom ``dist_sync_fn`` never sees it. Leaves are visited in sorted
    key order.
    """
    if dist_sync_fn is None and isinstance(group, ProcessGroup):
        return gather_group_pytrees(tree, group, policy=policy, report=report, precisions=sync_precisions)

    from metrics_tpu_torch.parallel import comm

    gather = dist_sync_fn or comm.gather_all_arrays
    leaves, spec = _flatten(tree)
    if not leaves:
        return [tree]
    fixed_flags = [False] * len(leaves)
    if dist_sync_fn is None and reductions and isinstance(tree, dict):
        fixed_flags = []
        for name in sorted(tree):
            value = tree[name]
            n = len(_flatten(value)[0])
            fixed_flags.extend([not isinstance(value, list) and reductions.get(name) in _SIMPLE_REDUCTIONS] * n)
    leaf_tags = (_leaf_precisions(tree, sync_precisions) if dist_sync_fn is None else None) or [None] * len(leaves)
    gathered = []  # [n_leaves][n_members]
    for leaf, fixed, tag in zip(leaves, fixed_flags, leaf_tags):
        try:
            if dist_sync_fn is None:
                gathered.append(gather(leaf, group=group, fixed_shape=fixed, precision=tag, report=report))
            else:
                gathered.append(list(gather(leaf, group=group)))
        except (SyncError, ValueError, TypeError, MetricsUserError):
            raise  # sync failures already classified, and programming errors
        except Exception as err:  # noqa: BLE001 - a collective or a custom gather failed; reclassified
            hint = ""
            if fixed:
                hint = (
                    " HINT: this leaf took the fixed-shape gather. If the metric's update() reassigns this"
                    " state to another shape than its registered default, declare it in the class's"
                    " `_shape_polymorphic_states` to keep it on the ragged gather."
                )
            raise SyncError(f"Host-level gather failed for a state leaf: {err}{hint}") from err
    n_members = len(gathered[0])
    return [_unflatten(spec, [per_leaf[m] for per_leaf in gathered]) for m in range(n_members)]


# ---------------------------------------------------------------------------
# the wire envelope as a registered durable family (resilience/schema.py):
# the sync path keeps its own version dispatch above; the registry serves
# payloads decoded out of band (the golden corpus, tooling) and counts them
# ---------------------------------------------------------------------------
def _wire_version_of(payload: bytes) -> int:
    if len(payload) < _ENVELOPE.size:
        raise SyncIntegrityError(
            f"Truncated sync payload: {len(payload)} bytes is smaller than the {_ENVELOPE.size}-byte wire envelope."
        )
    magic, version, _crc = _ENVELOPE.unpack(payload[: _ENVELOPE.size])
    if magic != _WIRE_MAGIC:
        raise SyncIntegrityError("Sync payload does not carry the metrics_tpu wire magic.", transient=False)
    return version


def _decode_wire_v1(payload: bytes, context: str) -> torch.Tensor:
    return _decode(payload, context, accept=(WIRE_VERSION,))


def _decode_wire_v2(payload: bytes, context: str) -> torch.Tensor:
    return _decode(payload, context, accept=(WIRE_VERSION_QUANTIZED,))


def _upcast_wire_v1(arr: torch.Tensor) -> torch.Tensor:
    """v1 to v2: both decode to the same array; v2 only adds codec metadata."""
    return arr


def _register_wire_schemas() -> None:
    from metrics_tpu_torch.resilience import schema as _schema

    _schema.register_schema("wire", WIRE_VERSION, _decode_wire_v1, upcast=_upcast_wire_v1, prober=_wire_version_of)
    _schema.register_schema("wire", WIRE_VERSION_QUANTIZED, _decode_wire_v2)


_register_wire_schemas()

"""The state-integrity plane's digests (counterpart of the digest half of
``metrics_tpu/resilience/integrity.py``).

:func:`state_digest` folds every state leaf's raw bytes into a cheap 64-bit
digest (an xor fold over 8-byte words with positional mixing: any single
flipped bit and any swapped word change it); :func:`verify_tree` checks a
tree against the digests sealed beside it and raises
:class:`~metrics_tpu_torch.utils.exceptions.StateIntegrityError` naming the
leaf. A leaf digests as its dtype (numpy's ``dtype.str``, ``<V2`` for
bfloat16, as the JAX package folds it), its shape and its bytes in C order
and native byte order, so a torch tensor and a numpy or JAX array of the
same values fold alike. Every check counts into :func:`integrity_stats`
(``obs.snapshot()["integrity"]``, the ``metrics_tpu_integrity_*``
families) and, while the bus records, emits an ``attest`` event.

The bank-bound half acts on a serving bank
(:class:`~metrics_tpu_torch.serving.MetricBank`) and its stored payloads:

* :func:`inject_bitflip` flips one bit of a resident tenant's row in place
  on the bank's device, at a site that is a pure function of ``seq`` (the
  JAX package's site, so both packages corrupt the same bit);
  :func:`bitflip_injector` wires it to a fault plan's ``bitflip_site``.
* :func:`forge_payload_corruption` corrupts one leaf of a sealed payload
  while keeping every crc valid, the corruption only the digests can see;
  :func:`forge_snapshot_corruption` does the same inside a sealed drive
  snapshot (``engine/driver.py``).
* :class:`IntegrityAuditor` drains a bank's sampled audits
  (``MetricBank(audit_rate=)``), replays each on a solo clone of the
  template and compares bit for bit; a mismatch is reported (an ``audit``
  event with ``ok`` False) and, with ``repair=True``, repaired from the
  last attested blob (``MetricBank.repair_tenant``, a ``repair`` event).
"""
import json
import struct
import threading
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.obs import bus as _obs_bus
from metrics_tpu_torch.utils.exceptions import StateIntegrityError

__all__ = [
    "AuditEntry",
    "IntegrityAuditor",
    "bitflip_injector",
    "bump",
    "fold_digest",
    "forge_payload_corruption",
    "forge_snapshot_corruption",
    "inject_bitflip",
    "integrity_stats",
    "leaf_digest",
    "reset_integrity_stats",
    "state_digest",
    "verify_tree",
]

# ---------------------------------------------------------------------------
# process-wide integrity telemetry — the "integrity" section of obs.snapshot()
# and the metrics_tpu_integrity_* Prometheus family
# ---------------------------------------------------------------------------
_STATS_LOCK = threading.Lock()


def _new_stats() -> Dict[str, int]:
    return {
        "attests_recorded": 0,
        "attests_verified": 0,
        "attest_failures": 0,
        "audits_sampled": 0,
        "audits_checked": 0,
        "audits_passed": 0,
        "audit_failures": 0,
        "audits_dropped": 0,
        "repairs": 0,
        "repair_failures": 0,
        "bitflips_injected": 0,
    }


_STATS = _new_stats()


def bump(key: str, n: int = 1) -> None:
    with _STATS_LOCK:
        _STATS[key] += n


def integrity_stats() -> Dict[str, int]:
    """Process-wide state-integrity counters: digests recorded/verified (and
    verification failures), shadow audits sampled/checked/passed/failed (and
    entries dropped to the capture bound), tenant repairs, and injected
    bitflips (chaos runs only)."""
    with _STATS_LOCK:
        return dict(_STATS)


def reset_integrity_stats() -> None:
    with _STATS_LOCK:
        for key in list(_STATS):
            _STATS[key] = 0


# ---------------------------------------------------------------------------
# sealed-state digests
# ---------------------------------------------------------------------------
_FOLD_SEED = 0xCBF29CE484222325
_FOLD_PRIME = 0x100000001B3
_FOLD_MIX = 0x9E3779B97F4A7C15
_U64 = 0xFFFFFFFFFFFFFFFF


def fold_digest(data: bytes) -> str:
    """64-bit xor/fold of ``data`` as a 16-hex-char string.

    Vectorized over 8-byte words with positional mixing (each word is
    multiplied by an odd position-dependent constant before the xor fold), so
    a single flipped bit is guaranteed to change the digest — odd
    multiplication is a bijection on Z/2^64 — and swapped or shifted words
    change it too, which a plain xor fold would miss. Orders of magnitude
    cheaper than a cryptographic hash; the threat model is hardware SDC, not
    an adversary.
    """
    n = len(data)
    pad = (-n) % 8
    if pad:
        data = data + b"\x00" * pad
    words = np.frombuffer(data, dtype="<u8")
    acc = _FOLD_SEED
    if words.size:
        idx = np.arange(1, words.size + 1, dtype=np.uint64)
        mixed = words * ((np.uint64(_FOLD_MIX) * idx) | np.uint64(1))
        acc ^= int(np.bitwise_xor.reduce(mixed))
    acc = ((acc ^ n) * _FOLD_PRIME) & _U64
    return format(acc, "016x")


def _leaf_bytes(value: Any) -> Tuple[str, Tuple[int, ...], bytes]:
    """``(dtype.str, shape, bytes)`` of a leaf, C order and native byte order."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "<V2", tuple(int(d) for d in t.shape), t.view(torch.int16).numpy().tobytes()
        arr = t.numpy()
    else:
        arr = np.asarray(value, order="C")
        arr = arr.astype(arr.dtype.newbyteorder("="), copy=False)
    return arr.dtype.str, tuple(arr.shape), arr.tobytes()


def leaf_digest(value: Any) -> str:
    """Digest one state leaf: its dtype, shape and raw bytes, normalized as
    the exact wire codec does (C order, native byte order), so a digest of
    live state equals that of the same leaf after a wire round trip."""
    dtype_str, shape, data = _leaf_bytes(value)
    meta = f"{dtype_str}|{shape}".encode()
    return fold_digest(meta + data)


def state_digest(tree: Dict[str, Any]) -> Dict[str, str]:
    """Per-leaf digests of a state tree (``{leaf_name: 16-hex digest}``).

    Leaf-granular rather than one tree-wide fold so a verification failure
    localizes the corruption (``StateIntegrityError.leaf``), and so codecs
    that only attest a subset of leaves (quantized wire payloads are lossy —
    their digests could never verify) can drop keys without losing coverage
    of the rest.
    """
    return {name: leaf_digest(value) for name, value in sorted(tree.items())}


def verify_tree(
    tree: Dict[str, Any],
    expected: Optional[Dict[str, str]],
    *,
    bank: Any = None,
    tenant: Any = None,
    context: str = "",
) -> None:
    """Verify ``tree`` against recorded per-leaf digests; raise on mismatch.

    ``expected`` maps leaf names to the digests sealed when the state last
    crossed an attestation point; ``None``/empty verifies nothing (payloads
    sealed before the integrity plane existed, quantized leaves). A missing
    or mismatching leaf raises :class:`StateIntegrityError` naming
    bank/tenant/leaf; every call lands in :func:`integrity_stats` and (bus
    enabled) emits an ``attest`` event.
    """
    if not expected:
        return
    failure: Optional[Tuple[str, str]] = None
    for leaf in sorted(expected):
        if leaf not in tree:
            failure = (leaf, "<missing>")
            break
        actual = leaf_digest(tree[leaf])
        if actual != expected[leaf]:
            failure = (leaf, actual)
            break
    if failure is None:
        bump("attests_verified")
        if _obs_bus.enabled():
            _obs_bus.emit(
                "attest",
                source="integrity",
                ok=True,
                bank=str(bank) if bank is not None else None,
                tenant=str(tenant) if tenant is not None else None,
                leaves=len(expected),
            )
        return
    leaf, actual = failure
    bump("attest_failures")
    if _obs_bus.enabled():
        _obs_bus.emit(
            "attest",
            source="integrity",
            ok=False,
            bank=str(bank) if bank is not None else None,
            tenant=str(tenant) if tenant is not None else None,
            leaf=leaf,
        )
    raise StateIntegrityError(
        f"State failed attestation{context}: leaf {leaf!r} folds to {actual}"
        f" but was sealed as {expected[leaf]} — the state bytes changed after"
        " they were attested (silent corruption, a stale/swapped blob, or a"
        " decode bug). This tenant's resident state cannot be trusted.",
        bank=bank,
        tenant=tenant,
        leaf=leaf,
    )


# ---------------------------------------------------------------------------
# fault injection: deterministic bitflips of resident state
# ---------------------------------------------------------------------------
def inject_bitflip(bank: Any, tenant: Hashable, seq: int = 0) -> Optional[Dict[str, Any]]:
    """Flip one bit of ``tenant``'s resident state, in place on the bank's
    device: the silent-corruption fault. The site is a pure function of
    ``seq``: the ``seq``-th non-empty leaf (cyclic over the sorted names)
    and a Knuth-hashed bit of that leaf's bytes in native byte order, as in
    the JAX package. Nothing is raised and no event emitted: detection must
    come from the digests or the shadow audit. Returns the site
    (``{"tenant", "leaf", "bit"}``), or None when the tenant is not
    resident. Takes the bank's (reentrant) lock. On a pod bank the
    processes that hold the tenant's row flip a bit of their slice; the
    others return None."""
    with bank._lock:
        slot = bank._slots.get(tenant)
        if slot is None or not bank._owns(slot):
            return None
        slot = bank._local_row(slot)
        names = sorted(bank._bank)
        leaf_name = None
        for probe in range(len(names)):
            candidate = names[(seq + probe) % len(names)]
            if bank._bank[candidate][slot].numel() > 0:
                leaf_name = candidate
                break
        if leaf_name is None:
            return None
        row = bank._bank[leaf_name][slot]
        raw = bytearray(_leaf_bytes(row)[2])
        bit = (seq * 2654435761 + 17) % (len(raw) * 8)
        raw[bit // 8] ^= 1 << (bit % 8)
        flipped = torch.frombuffer(raw, dtype=torch.uint8).view(row.dtype).reshape(row.shape)
        row.copy_(flipped.to(row.device))
    bump("bitflips_injected")
    return {"tenant": tenant, "leaf": leaf_name, "bit": int(bit)}


def bitflip_injector(bank: Any, plan: Any, rank: int, epoch_fn: Optional[Callable[[], Any]] = None) -> Callable[[List[Hashable]], None]:
    """A ``state_fault_injector`` for ``bank`` driven by a fault plan's
    ``'bitflip'`` specs against worker ``rank``: each flush claims
    ``plan.bitflip_site(rank, epoch)`` and, while the plan owes flips, flips
    a bit of the flush's tenant number ``seq % len(tenants)`` (the JAX
    fleet's seam). Install with ``bank.state_fault_injector = ...``."""

    def inject(tenants: List[Hashable]) -> None:
        epoch = epoch_fn() if epoch_fn is not None else None
        seq = plan.bitflip_site(rank, epoch)
        if seq is None or not tenants:
            return
        inject_bitflip(bank, tenants[seq % len(tenants)], seq=seq)

    return inject


# ---------------------------------------------------------------------------
# forged corruption of sealed payloads
# ---------------------------------------------------------------------------
def forge_payload_corruption(payload: bytes, *, leaf: Optional[str] = None, bit: int = 0) -> bytes:
    """Corrupt one leaf inside a sealed tenant payload and keep every crc32
    self-consistent: ``bit`` of ``leaf``'s data region (the first leaf with
    data by default) is flipped and the leaf's inner envelope re-sealed,
    while the outer header, with the digests sealed in it, is kept. Decoding
    then passes every crc and fails only the digest check, the shape of a
    corruption upstream of sealing."""
    from metrics_tpu_torch.parallel import groups as _groups

    version, body = _groups.unpack_envelope(payload, " (forge)")
    (header_len,) = struct.unpack(">I", body[:4])
    keys = json.loads(body[4 : 4 + header_len].decode())["keys"]
    offset = 4 + header_len
    blocks: List[bytes] = []
    for _ in keys:
        (block_len,) = struct.unpack(">Q", body[offset : offset + 8])
        offset += 8
        blocks.append(body[offset : offset + block_len])
        offset += block_len
    target = keys.index(leaf) if leaf is not None else None
    if target is None:
        for i, block in enumerate(blocks):
            _iv, ibody = _groups.unpack_envelope(block, " (forge)")
            (ihl,) = struct.unpack(">I", ibody[:4])
            if len(ibody) > 4 + ihl:
                target = i
                break
        if target is None:
            raise ValueError("payload has no leaf with a non-empty data region to corrupt")
    iv, ibody = _groups.unpack_envelope(blocks[target], " (forge)")
    (ihl,) = struct.unpack(">I", ibody[:4])
    data = bytearray(ibody[4 + ihl :])
    if not data:
        raise ValueError(f"leaf {keys[target]!r} has no data bytes to corrupt")
    site = bit % (len(data) * 8)
    data[site // 8] ^= 1 << (site % 8)
    blocks[target] = _groups.pack_envelope(ibody[: 4 + ihl] + bytes(data), iv)
    new_body = body[: 4 + header_len] + b"".join(struct.pack(">Q", len(b)) + b for b in blocks)
    return _groups.pack_envelope(new_body, version)


def forge_snapshot_corruption(payload: bytes, *, leaf: Optional[str] = None, bit: int = 0) -> bytes:
    """:func:`forge_payload_corruption` for a sealed drive snapshot: the
    inner tenant payload is forged and the snapshot's envelope sealed again,
    so ``drive(resume_from=)`` sees valid crcs and a failing digest. A
    ``leaf`` is named in the flat payload's ``"member\x00state"`` form."""
    from metrics_tpu_torch.parallel import groups as _groups

    version, body = _groups.unpack_envelope(payload, " (forge)")
    (meta_len,) = struct.unpack(">I", body[:4])
    inner = forge_payload_corruption(body[4 + meta_len :], leaf=leaf, bit=bit)
    return _groups.pack_envelope(body[: 4 + meta_len] + inner, version)


# ---------------------------------------------------------------------------
# shadow-replay audit
# ---------------------------------------------------------------------------
class AuditEntry:
    """One sampled flush's evidence for one tenant: the request args applied
    to it, its update count before the flush, and an
    :class:`~metrics_tpu_torch.engine.AsyncResult` over copies of its pre
    and post rows (copies: the bank is written in place, and a later wave
    must not change the evidence)."""

    __slots__ = ("tenant", "args_list", "count_before", "capture", "flush_index")

    def __init__(self, tenant: Hashable, args_list: List[Tuple[Any, ...]], count_before: int, capture: Any, flush_index: int) -> None:
        self.tenant = tenant
        self.args_list = args_list
        self.count_before = int(count_before)
        self.capture = capture
        self.flush_index = int(flush_index)


class IntegrityAuditor:
    """Re-execute sampled flushes on a solo clone and compare bit for bit.

    A bank tenant is bit-identical to a solo instance fed the same requests.
    For every capture :meth:`poll` drains from the bank, the auditor binds
    the pre-state onto a clone of the template, replays the tenant's
    requests and compares the result with the post-state byte for byte. A
    divergence means the resident row changed between capture points (or a
    kernel computed a wrong row): it is counted, emitted as an ``audit``
    event with ``ok`` False and, with ``repair=True``, repaired through
    ``MetricBank.repair_tenant``. Run it off the serving path; the
    captures' copies to the host resolve here."""

    def __init__(self, bank: Any, *, repair: bool = True) -> None:
        self.bank = bank
        self.repair = repair
        self.last_failure: Optional[Dict[str, Any]] = None

    def poll(self) -> Dict[str, int]:
        """Audit every pending capture; this poll's verdict counts."""
        out = {"checked": 0, "passed": 0, "failed": 0, "repaired": 0}
        for entry in self.bank.take_audits():
            out["checked"] += 1
            bump("audits_checked")
            mismatch = self._check(entry)
            if mismatch is None:
                out["passed"] += 1
                bump("audits_passed")
                self._emit(entry, ok=True)
                continue
            out["failed"] += 1
            bump("audit_failures")
            self.last_failure = {"tenant": entry.tenant, "leaf": mismatch}
            self._emit(entry, ok=False, leaf=mismatch)
            if self.repair:
                try:
                    self.bank.repair_tenant(entry.tenant)
                    out["repaired"] += 1
                except Exception:  # noqa: BLE001 — a failed repair is counted, not fatal to the poll
                    bump("repair_failures")
        return out

    def _check(self, entry: AuditEntry) -> Optional[str]:
        """Replay the entry on a solo clone; the first diverging leaf, or None."""
        fetched = entry.capture.result()
        pre, post = fetched["pre"], fetched["post"]
        clone = self.bank._template.clone()
        clone.bind_state(pre, update_count=entry.count_before)
        for args in entry.args_list:
            clone.update(*args)
        replay = clone._snapshot_state()
        for leaf in sorted(post):
            want = _leaf_bytes(replay[leaf])
            got = _leaf_bytes(post[leaf])
            if want != got:
                return leaf
        return None

    def _emit(self, entry: AuditEntry, ok: bool, leaf: Optional[str] = None) -> None:
        if not _obs_bus.enabled():
            return
        data: Dict[str, Any] = {
            "ok": ok,
            "bank": self.bank.name,
            "tenant": str(entry.tenant),
            "requests": len(entry.args_list),
            "flush": entry.flush_index,
        }
        if leaf is not None:
            data["leaf"] = leaf
        _obs_bus.emit("audit", source="integrity", **data)

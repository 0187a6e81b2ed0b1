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

The bank-bound half of the JAX module (``inject_bitflip``, the forge
helpers, ``AuditEntry`` and ``IntegrityAuditor``) acts on a serving bank
and its stored payloads, and comes with the serving layer (ROADMAP §1
items 8 and 10).
"""
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from metrics_tpu_torch.obs import bus as _obs_bus
from metrics_tpu_torch.utils.exceptions import StateIntegrityError

__all__ = [
    "bump",
    "fold_digest",
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

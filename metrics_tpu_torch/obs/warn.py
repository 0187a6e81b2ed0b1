"""Rank-zero, once-per-key warnings (counterpart of ``metrics_tpu/obs/warn.py``).

An eval loop that re-validates the same config warns on every batch; this
keeps one warning per key for the process, on rank zero only:

* the key defaults to ``(message, category)``; a site that formats varying
  detail into the message gets one warning per detail, and a site that
  wants coarser dedup passes ``key``;
* every occurrence is counted (:func:`warn_counts`), and the first one goes
  on the event bus as a ``warning`` event with its ``repeat`` count, on
  every rank, so dedup hides nothing from the telemetry, only from stderr;
* ``METRICS_TPU_WARN_EVERY=1`` turns dedup off for the process;
* :func:`reset_warn_once` re-arms keys (tests do this between cases so
  ``pytest.warns`` keeps working).
"""
import itertools
import os
import threading
import warnings as _warnings
from typing import Dict, Hashable, Optional, Type

from metrics_tpu_torch.obs import bus as _bus
from metrics_tpu_torch.utils.prints import _rank

_LOCK = threading.RLock()
_SEEN: Dict[Hashable, int] = {}
_TOKEN_SEQ = itertools.count()


def instance_token() -> int:
    """Process-unique token for keying per-instance warnings (``id()`` is recycled)."""
    return next(_TOKEN_SEQ)


def _dedup_disabled() -> bool:
    return os.environ.get("METRICS_TPU_WARN_EVERY", "") == "1"


def warn_once(
    message: str,
    category: Type[Warning] = UserWarning,
    key: Optional[Hashable] = None,
    stacklevel: int = 2,
) -> bool:
    """Emit ``message`` once per ``key`` on process rank zero. True when the
    warning was emitted; False when it was a repeat or this is not rank
    zero. Repeats are counted either way."""
    dedup_key: Hashable = key if key is not None else (message, category.__name__)
    with _LOCK:
        seen = _SEEN.get(dedup_key, 0)
        _SEEN[dedup_key] = seen + 1
    if seen and not _dedup_disabled():
        return False
    if _bus.enabled():
        _bus.emit("warning", source=category.__name__, message=str(message), key=repr(dedup_key), repeat=seen)
    if _rank() != 0:
        return False
    _warnings.warn(message, category, stacklevel=stacklevel)
    return True


def warn_counts() -> Dict[Hashable, int]:
    """Occurrences per dedup key, emitted and suppressed."""
    with _LOCK:
        return dict(_SEEN)


def seen_count(key: Hashable) -> int:
    with _LOCK:
        return _SEEN.get(key, 0)


def reset_warn_once(key: Optional[Hashable] = None) -> None:
    """Forget one key (or all of them), re-arming the corresponding warning."""
    with _LOCK:
        if key is None:
            _SEEN.clear()
        else:
            _SEEN.pop(key, None)

"""Once-per-key warnings (counterpart of ``metrics_tpu/obs/warn.py``).

An eval loop that re-validates the same config warns on every batch; this
keeps one warning per key for the process. The key defaults to
``(message, category)``. :func:`reset_warn_once` re-arms keys (tests do this
between cases so ``pytest.warns`` keeps working).
"""
import itertools
import threading
import warnings as _warnings
from typing import Dict, Hashable, Optional, Type

_LOCK = threading.Lock()
_SEEN: Dict[Hashable, int] = {}
_TOKEN_SEQ = itertools.count()


def instance_token() -> int:
    """Process-unique token for keying per-instance warnings (``id()`` is recycled)."""
    return next(_TOKEN_SEQ)


def warn_once(
    message: str,
    category: Type[Warning] = UserWarning,
    key: Optional[Hashable] = None,
    stacklevel: int = 2,
) -> bool:
    """Emit ``message`` once per ``key``; True when it was emitted."""
    dedup_key: Hashable = key if key is not None else (message, category.__name__)
    with _LOCK:
        seen = _SEEN.get(dedup_key, 0)
        _SEEN[dedup_key] = seen + 1
    if seen:
        return False
    _warnings.warn(message, category, stacklevel=stacklevel)
    return True


def reset_warn_once(key: Optional[Hashable] = None) -> None:
    """Forget one key (or all of them), re-arming the corresponding warning."""
    with _LOCK:
        if key is None:
            _SEEN.clear()
        else:
            _SEEN.pop(key, None)

"""Opt-in persistent kernel cache: a restarted worker loads the kernel
library instead of building it (counterpart of ``metrics_tpu/engine/persist.py``).

The JAX package points JAX's persistent compilation cache at a directory,
so a restarted worker loads its compiled programs from disk. The port has
no such cache to point: its programs are CUDA graphs, which belong to the
process that captured them and cannot be saved. The one compiled artifact
of the port that does outlive a process is the kernel library that
``ops/_build.py`` builds with ``nvcc`` from ``csrc/``. So here the
persistent cache is that library's directory:

* :func:`enable_persistent_cache` makes ``ops/_build.py`` build into and
  load from ``path`` (by default the library goes to the package's
  ``_build/``). The library's name hashes its sources and flags, so one
  directory serves any number of checkouts and an edited kernel rebuilds.
* ``METRICS_TPU_COMPILE_CACHE=<path>`` enables it when the engine is
  imported (the JAX package's variable).
* **Counting.** While enabled, the library's load counts: an existing
  ``.so`` is a ``persistent_hit`` (and a ``compile`` bus event tagged
  ``persistent_hit=True``, source ``persistent_cache``), an ``nvcc`` build
  a ``persistent_miss``. A process loads the library once, so it counts
  one or the other. :func:`persistent_cache_stats` is embedded in
  ``engine.cache_summary()``. A failed build still raises.
"""
import os
import threading
from typing import Any, Dict, Optional

from metrics_tpu_torch.obs import bus as _bus

__all__ = [
    "ENV_VAR",
    "enable_persistent_cache",
    "persistent_cache_enabled",
    "persistent_cache_stats",
]

ENV_VAR = "METRICS_TPU_COMPILE_CACHE"

_LOCK = threading.Lock()
_STATE: Dict[str, Any] = {
    "enabled": False,
    "path": None,
    "persistent_hits": 0,
    "persistent_misses": 0,
}


def enable_persistent_cache(path: Optional[str] = None) -> str:
    """Build and load the kernel library in ``path`` (or
    ``$METRICS_TPU_COMPILE_CACHE``) from now on; returns the resolved path.
    Idempotent; enabling again with another path moves the cache. A library
    this process already loaded stays loaded."""
    path = path or os.environ.get(ENV_VAR)
    if not path:
        raise ValueError(
            "enable_persistent_cache needs a directory: pass `path` or set"
            f" the {ENV_VAR} environment variable."
        )
    path = os.path.abspath(os.path.expanduser(path))
    os.makedirs(path, exist_ok=True)
    with _LOCK:
        _STATE["enabled"] = True
        _STATE["path"] = path
    return path


def persistent_cache_enabled() -> bool:
    return bool(_STATE["enabled"])


def cache_dir() -> Optional[str]:
    """Where ``ops/_build.py`` builds and loads the library: the enabled
    cache's path, or None for the package's own ``_build/``."""
    return _STATE["path"] if _STATE["enabled"] else None


def note_load(built: bool) -> None:
    """Count one load of the kernel library while the cache is enabled: a
    build is a miss, a reused library a hit (with its bus event)."""
    if not _STATE["enabled"]:
        return
    with _LOCK:
        _STATE["persistent_misses" if built else "persistent_hits"] += 1
    if not built and _bus.enabled():
        _bus.emit("compile", source="persistent_cache", persistent_hit=True, path=str(_STATE["path"]))


def persistent_cache_stats() -> Dict[str, Any]:
    """``{enabled, path, persistent_hits, persistent_misses}``, embedded in
    ``engine.cache_summary()`` and the process ``obs.snapshot()``."""
    with _LOCK:
        return {
            "enabled": _STATE["enabled"],
            "path": _STATE["path"],
            "persistent_hits": _STATE["persistent_hits"],
            "persistent_misses": _STATE["persistent_misses"],
        }


def _maybe_enable_from_env() -> None:
    """Import-time wiring (called by ``metrics_tpu_torch.engine``): with
    ``METRICS_TPU_COMPILE_CACHE`` set, the cache is enabled with no code
    change. A bad path is a warning, never an import error."""
    if not os.environ.get(ENV_VAR):
        return
    try:
        enable_persistent_cache()
    except Exception as err:  # noqa: BLE001 — import-time: degrade, don't die
        import warnings

        warnings.warn(
            f"{ENV_VAR} is set but the persistent kernel cache could not be enabled: {err}",
            RuntimeWarning,
            stacklevel=2,
        )

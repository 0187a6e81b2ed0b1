"""The multi-tenant serving plane (counterpart of ``metrics_tpu/serving``):
thousands of sessions of one metric served from one device-resident bank.

* :class:`MetricBank` (``serving/bank.py``): up to ``capacity`` sessions of
  one metric or fusable collection as device tensors with a leading tenant
  axis, a wave of ``(tenant, update)`` requests applied in one program,
  LRU spill of cold tenants, the write-ahead journal and crash recovery,
  shadow audits.
* :class:`RequestRouter` (``serving/router.py``): groups incoming requests
  by signature and flushes size- or deadline-bounded waves into a bank.
* :class:`RequestDedup` (``serving/dedup.py``): exactly-once apply of
  requests tagged with a ``request_id``.
* :class:`SpillStore`, :class:`MemoryStore`, :class:`DiskStore`,
  :class:`OrbaxStore` (``serving/store.py``): the spill tiers and the
  journal codec, byte-compatible with the JAX package.
* :func:`serving_summary` (``obs.snapshot()["serving"]``, the
  ``metrics_tpu_bank_*`` families) and :func:`durability_stats`
  (``["durability"]``, ``metrics_tpu_durable_*``).
"""
from metrics_tpu_torch.serving.store import (  # noqa: F401  (before the bank, which uses it)
    DiskStore,
    MemoryStore,
    OrbaxStore,
    SpillStore,
    durability_stats,
)
from metrics_tpu_torch.serving.bank import MetricBank, all_banks, serving_summary  # noqa: F401
from metrics_tpu_torch.serving.dedup import RequestDedup  # noqa: F401
from metrics_tpu_torch.serving.router import RequestRouter  # noqa: F401

__all__ = [
    "DiskStore",
    "MemoryStore",
    "MetricBank",
    "OrbaxStore",
    "RequestDedup",
    "RequestRouter",
    "SpillStore",
    "all_banks",
    "durability_stats",
    "serving_summary",
]

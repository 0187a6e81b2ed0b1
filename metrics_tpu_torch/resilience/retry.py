"""Deadline-aware retry/backoff policy for the host-level store sync
(counterpart of ``metrics_tpu/resilience/retry.py``, value for value).

A :class:`~metrics_tpu_torch.parallel.groups.ProcessGroup` owns one total deadline
(``timeout_s``); this module splits it into per-attempt budgets so a flaky
peer gets several chances to publish *within* the same overall deadline —
never extending it. Backoff between attempts is exponential with
deterministic jitter: the jitter factor is a hash of (scope, epoch, peer,
attempt), so two ranks retrying against the same straggler decorrelate
without any process-global RNG state, and a failing exchange replays
identically under the fault-injection harness.

Pure stdlib: importable from anywhere in the package.
"""
import zlib
from dataclasses import dataclass
from typing import Any, Tuple

__all__ = ["DEFAULT_RETRY", "RetryPolicy"]


@dataclass(frozen=True)
class RetryPolicy:
    """How a group member retries transient KV failures inside one exchange.

    Args:
        max_attempts: KV read attempts per peer payload (>= 1). The group's
            ``timeout_s`` is split across the attempts still remaining, so
            attempt ``k`` gets roughly ``remaining / (max_attempts - k + 1)``.
        backoff_base_s: backoff before the 2nd attempt; doubles per attempt.
        backoff_max_s: cap on a single backoff pause.
        jitter: fractional jitter applied to each pause — a pause of ``b``
            becomes ``b * (1 ± jitter * u)`` with ``u`` deterministic in
            ``[0, 1)`` from the (scope, epoch, peer, attempt) key.
        min_attempt_s: floor on a single attempt's KV-get budget, so a nearly
            exhausted deadline still issues a real (if brief) read.
    """

    max_attempts: int = 3
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    jitter: float = 0.5
    min_attempt_s: float = 0.001

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")
        if self.backoff_base_s < 0 or self.backoff_max_s < 0:
            raise ValueError("backoff durations must be non-negative")

    def attempt_timeout_s(self, remaining_s: float, attempts_left: int) -> float:
        """Budget for the next KV get: the remaining deadline split evenly
        across the attempts still allowed (floored at ``min_attempt_s``)."""
        return max(self.min_attempt_s, remaining_s / max(1, attempts_left))

    def backoff_s(self, attempt: int, key: Tuple[Any, ...] = ()) -> float:
        """Pause before attempt ``attempt + 1`` (``attempt`` is 1-based and
        just failed). Exponential in the attempt index, capped, with
        deterministic jitter derived from ``key``."""
        base = min(self.backoff_max_s, self.backoff_base_s * (2 ** (attempt - 1)))
        if self.jitter == 0.0 or base == 0.0:
            return base
        unit = zlib.crc32(repr((key, attempt)).encode()) / 2**32  # [0, 1)
        return base * (1.0 + self.jitter * (2.0 * unit - 1.0))


DEFAULT_RETRY = RetryPolicy()

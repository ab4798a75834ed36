"""Retry policy of the sweep runner (port of the part of
``repro.sim.dispatch`` that the in-process runner reads).

``repro``'s file-system lease queue, which drives a sweep from several
worker processes, is not ported yet (ROADMAP queue 1, item 6); its knobs
below (heartbeats, leases, stragglers, respawns) are kept so a policy
means the same in both packages.
"""

from __future__ import annotations

import dataclasses
import hashlib

__all__ = ["RetryPolicy"]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry, backoff and lease knobs for chunk execution.

    The default ``max_attempts=2`` is the runner's retry-once. Backoff for
    attempt ``k`` (the count of failures so far, from 1) is
    ``backoff_base_s * backoff_mult**(k-1)`` capped at ``backoff_max_s``,
    plus a deterministic jitter in ``[0, jitter * backoff)`` from a sha256
    of ``(key, attempt)``: no global RNG, so a re-run backs off the same
    and two chunks do not retry in lockstep.
    """

    max_attempts: int = 2          # total attempts before a chunk is filled
    backoff_base_s: float = 0.25   # first retry delay
    backoff_mult: float = 2.0      # exponential growth per attempt
    backoff_max_s: float = 30.0    # backoff ceiling
    jitter: float = 0.5            # jitter fraction of the backoff
    heartbeat_s: float = 0.5       # worker lease-renewal period
    lease_ttl_s: float = 5.0       # heartbeat age before a lease expires
    poll_s: float = 0.05           # coordinator/worker queue poll period
    straggler_quantile: float = 0.75   # completion-latency quantile ...
    straggler_factor: float = 4.0      # ... times this = re-dispatch age
    straggler_min_done: int = 3    # completions before stragglers re-dispatch
    max_duplicates: int = 1        # duplicate tasks per chunk (stragglers)
    max_respawns: int = 8          # replacement workers the pool may spawn
    stall_timeout_s: float = 60.0  # no progress + no live workers => fail

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.lease_ttl_s <= self.heartbeat_s:
            raise ValueError("lease_ttl_s must exceed heartbeat_s")

    def backoff(self, attempt: int, key: str = "") -> float:
        """Delay before retrying after the ``attempt``-th failure."""
        base = min(
            self.backoff_base_s * self.backoff_mult ** max(attempt - 1, 0),
            self.backoff_max_s,
        )
        if self.jitter <= 0.0:
            return base
        h = hashlib.sha256(f"{key}:{attempt}".encode()).digest()
        u = int.from_bytes(h[:8], "big") / 2.0 ** 64
        return base * (1.0 + self.jitter * u)

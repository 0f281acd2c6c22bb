"""Retry policy: exponential backoff with decorrelated jitter.

The policy is a frozen value object (like `PipelineConfig`): the server
consults it after a transient flush failure to decide which tickets get
another attempt and how long the bucket backs off before the next one.
Backoff never sleeps — the server records ``now + backoff_s`` per bucket
and `pump()` skips that bucket until the (injectable) clock passes it,
so tests drive the whole schedule with a FakeClock.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class RetryPolicy:
    """Typed retry/backoff/deadline knobs for failed dispatches.

    max_attempts: dispatch attempts per ticket (1 = no retries; the
        CLI's --no-retry baseline). A ticket whose attempts are
        exhausted resolves to a `RetryExhaustedError` result.
    base_ms / cap_ms: the decorrelated-jitter backoff window — attempt k
        backs off uniform(base, min(cap, 3 * previous backoff)) ms,
        AWS-style decorrelated jitter: retries spread instead of
        synchronizing into waves.
    deadline_ms: absolute per-ticket budget measured from enqueue; a
        ticket that has not dispatched successfully within it resolves
        to a `DeadlineExceededError` (counted under ``timeouts``).
        ``None`` = no absolute deadline. Only evaluated on the retry
        path, so fault-free serving never pays for (or changes under) it.
    seed: jitter seed — the whole backoff schedule is deterministic per
        (seed, attempt), chaos runs replay bit-identically.
    """

    max_attempts: int = 4
    base_ms: float = 1.0
    cap_ms: float = 50.0
    deadline_ms: float | None = None
    seed: int = 0

    def backoff_s(self, attempt: int, prev_s: float | None = None) -> float:
        """Backoff in seconds after failed attempt `attempt` (1-based).

        Decorrelated jitter: uniform between the base and three times
        the previous backoff, capped. Deterministic per (seed, attempt);
        always strictly positive so a backoff window exists even under a
        frozen fake clock.
        """
        base = max(self.base_ms, 1e-3) / 1e3
        cap = max(self.cap_ms, self.base_ms) / 1e3
        prev = prev_s if prev_s is not None else base
        hi = min(cap, max(base, 3.0 * prev))
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=self.seed,
                                   spawn_key=(max(1, attempt),)))
        return float(rng.uniform(base, hi)) if hi > base else base

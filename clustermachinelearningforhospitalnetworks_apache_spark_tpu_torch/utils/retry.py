"""Retry with exponential backoff + jitter — the transient-fault half of
self-healing (the WAL/checkpoint machinery is the durable half).

One policy object serves every caller: per-hospital-source file reads,
micro-batch replays, artifact IO.  Jitter is drawn from a caller-supplied
``random.Random`` so tests are deterministic and a fleet of sources
doesn't retry in lockstep (the thundering-herd problem the jitter term in
every production backoff exists for).

:class:`~.faults.InjectedCrash` is a ``BaseException`` and therefore never
retried — a simulated process death must end the "process", not be
absorbed by the very resilience layer it is testing.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, TypeVar

T = TypeVar("T")


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff: delay_n = base · multiplier^(n-1), capped at
    ``max_delay_s``, then scaled by a ±``jitter`` fraction."""

    max_attempts: int = 3
    base_delay_s: float = 0.02
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5
    retryable: tuple[type[Exception], ...] = (OSError,)

    def delay_for(self, attempt: int, rng: random.Random) -> float:
        raw = min(
            self.base_delay_s * self.multiplier ** max(attempt - 1, 0),
            self.max_delay_s,
        )
        if self.jitter:
            raw *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(raw, 0.0)


#: shared defaults: sources (quick IO retries) and batch replays (slower)
DEFAULT_IO_RETRY = RetryPolicy()
DEFAULT_REPLAY_BACKOFF = RetryPolicy(max_attempts=3, base_delay_s=0.05)


def call_with_retry(
    fn: Callable[[], T],
    policy: RetryPolicy = DEFAULT_IO_RETRY,
    rng: random.Random | None = None,
    on_retry: Callable[[int, Exception, float], None] | None = None,
    sleep: Callable[[float], None] = time.sleep,
) -> T:
    """Run ``fn`` with up to ``policy.max_attempts`` attempts.  The final
    failure re-raises the original exception; ``on_retry(attempt, exc,
    delay)`` fires before each backoff sleep (metrics/logging hook).

    The default RNG is entropy-seeded — a fleet of callers must NOT share
    one jitter stream (identically-seeded jitter retries in lockstep,
    which is the thundering herd jitter exists to break).  Pass a seeded
    ``random.Random`` only where a test needs reproducible delays."""
    rng = rng or random.Random()
    attempt = 1
    while True:
        try:
            return fn()
        except policy.retryable as e:
            if attempt >= policy.max_attempts:
                raise
            d = policy.delay_for(attempt, rng)
            if on_retry is not None:
                on_retry(attempt, e, d)
            sleep(d)
            attempt += 1

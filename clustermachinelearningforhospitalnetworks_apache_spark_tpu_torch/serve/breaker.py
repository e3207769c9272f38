"""Circuit breaker for model executables: closed → open → half-open.

The serving-side analogue of the stream's poison-batch quarantine: a
primary model that keeps failing (corrupt artifact hot-loaded, device in
a bad state, injected fault) must not have every request pay its failure
latency.  After ``failure_threshold`` consecutive failures the breaker
OPENS — requests short-circuit straight to the degraded/fallback path
without touching the device.  After ``recovery_timeout_s`` it admits
``half_open_max_calls`` probe requests (HALF-OPEN); a probe success
closes the breaker, a probe failure re-opens it and restarts the clock.

Pure host-side state under one lock — no device, unit-testable with a fake
clock (``clock=`` is injectable for exactly that).
"""

from __future__ import annotations

import threading
import time
from typing import Callable

STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half_open"


class CircuitBreaker:
    def __init__(
        self,
        failure_threshold: int = 5,
        recovery_timeout_s: float = 5.0,
        half_open_max_calls: int = 1,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Callable[[str, str], None] | None = None,
    ):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.recovery_timeout_s = recovery_timeout_s
        self.half_open_max_calls = max(half_open_max_calls, 1)
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        #: open-transition postmortem payload, staged under the lock and
        #: DUMPED AFTER it releases (see _flush_open_dump)
        self._pending_dump: dict | None = None
        self._state = STATE_CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._half_open_inflight = 0
        self._half_open_successes = 0
        self.opened_count = 0          # lifetime open transitions
        self.short_circuited = 0       # calls refused while open
        self.tripped_count = 0         # forced opens via trip()
        self._last_trip_reason = ""
        self._last_reset_reason = ""   # forced closes via reset()

    # ------------------------------------------------------------ internals
    def _to(self, state: str) -> None:
        old, self._state = self._state, state
        if state == STATE_OPEN:
            self._opened_at = self._clock()
            self.opened_count += 1
            # a breaker opening IS a failure event: STAGE a postmortem.
            # The dump itself (metrics collect + fsync'd write) must run
            # OUTSIDE self._lock — it snapshots every breaker on the
            # server, so dumping in here would stall concurrent allow()
            # calls and deadlock ABBA when two breakers open at once.
            self._pending_dump = {
                "from_state": old,
                "reason": self._last_trip_reason or "failures",
                "consecutive_failures": self._consecutive_failures,
            }
        if state == STATE_HALF_OPEN:
            self._half_open_inflight = 0
            self._half_open_successes = 0
        if state == STATE_CLOSED:
            self._consecutive_failures = 0
        if self._on_transition is not None and old != state:
            self._on_transition(old, state)

    def _flush_open_dump(self) -> None:
        """Write the staged open-transition postmortem — called by every
        public mutator AFTER its lock block, so the flight-recorder dump
        (which re-reads breaker snapshots via the metrics collectors)
        never runs while this breaker's lock is held."""
        payload, self._pending_dump = self._pending_dump, None
        if payload is not None:
            from ..obs.flight_recorder import notify

            notify("breaker_trip", "serve.breaker", **payload)

    # ------------------------------------------------------------ protocol
    def allow(self) -> bool:
        """May this call hit the primary?  (Counts half-open probes.)"""
        with self._lock:
            if self._state == STATE_OPEN:
                if self._clock() - self._opened_at >= self.recovery_timeout_s:
                    self._to(STATE_HALF_OPEN)
                else:
                    self.short_circuited += 1
                    return False
            if self._state == STATE_HALF_OPEN:
                if self._half_open_inflight >= self.half_open_max_calls:
                    self.short_circuited += 1
                    return False
                self._half_open_inflight += 1
            return True

    def record_success(self) -> None:
        with self._lock:
            if self._state == STATE_HALF_OPEN:
                self._half_open_successes += 1
                if self._half_open_successes >= self.half_open_max_calls:
                    self._to(STATE_CLOSED)
            else:
                self._consecutive_failures = 0

    def trip(self, reason: str = "") -> None:
        """Force the breaker OPEN regardless of failure counts — the
        entry point for *external* degradation signals (sustained input
        drift, operator action).  Requests short-circuit to the fallback
        until the recovery timeout, exactly like failure-opened state;
        half-open probes then test the primary as usual."""
        with self._lock:
            self.tripped_count += 1
            self._last_trip_reason = reason
            if self._state != STATE_OPEN:
                self._to(STATE_OPEN)
            else:  # already open: restart the recovery clock
                self._opened_at = self._clock()
        self._flush_open_dump()

    def reset(self, reason: str = "") -> None:
        """Force the breaker CLOSED — the promotion-side counterpart of
        :meth:`trip`.  A freshly promoted model must answer immediately:
        the opens its predecessor accumulated (drift trips included) say
        nothing about the new executable, so the failure count and the
        recovery clock start over.  ``last_trip_reason`` is left intact —
        an operator auditing why the breaker ever opened must see the
        trip's cause, not the reset's label."""
        with self._lock:
            self._last_reset_reason = reason
            if self._state != STATE_CLOSED:
                self._to(STATE_CLOSED)
            else:
                self._consecutive_failures = 0

    def record_failure(self) -> None:
        with self._lock:
            if self._state == STATE_HALF_OPEN:
                self._to(STATE_OPEN)  # failed probe: back off again
            else:
                self._consecutive_failures += 1
                if (
                    self._state == STATE_CLOSED
                    and self._consecutive_failures >= self.failure_threshold
                ):
                    self._to(STATE_OPEN)
        self._flush_open_dump()

    # ------------------------------------------------------------ observe
    @property
    def state(self) -> str:
        with self._lock:
            # surface the would-transition so health checks don't report
            # "open" forever on an idle server past its recovery timeout
            if (
                self._state == STATE_OPEN
                and self._clock() - self._opened_at >= self.recovery_timeout_s
            ):
                return STATE_HALF_OPEN
            return self._state

    def snapshot(self) -> dict:
        with self._lock:
            state = self._state
            # same would-transition view as .state: an idle breaker past
            # its recovery window must not read "open" forever in health
            if (
                state == STATE_OPEN
                and self._clock() - self._opened_at >= self.recovery_timeout_s
            ):
                state = STATE_HALF_OPEN
            return {
                "state": state,
                "consecutive_failures": self._consecutive_failures,
                "opened_count": self.opened_count,
                "short_circuited": self.short_circuited,
                "tripped_count": self.tripped_count,
                "last_trip_reason": self._last_trip_reason,
                "last_reset_reason": self._last_reset_reason,
            }

"""Bounded request queue: backpressure, deadlines, graceful degradation.

The serving layer's stability contract, in order of preference when load
exceeds capacity:

1. **Backpressure** — the queue is bounded in ROWS (one 256-row request
   is 256 singles' worth of work); admission never blocks.
2. **Shed** — an over-bound request is answered at once with status
   ``rejected`` (with a fallback's prediction when one is configured).
3. **Deadline drop** — a request whose deadline expires while queued is
   answered ``deadline_exceeded`` instead of being served late.

Pure host-side bookkeeping; nothing here touches a device.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..tune import default as knob_default
from ..tune import knob

#: the declared default of the ``serve.queue.max_rows`` knob; a queue
#: built with ``max_rows=None`` resolves the knob instead
DEFAULT_MAX_QUEUE_ROWS = knob_default("serve.queue.max_rows")

#: result statuses, 503-analogue semantics
STATUS_OK = "ok"
STATUS_REJECTED = "rejected"             # queue saturated at admission
STATUS_DEADLINE_EXCEEDED = "deadline_exceeded"
#: never answered here (a primary failure answers ``unavailable``);
#: exported for clients that branch on it
STATUS_ERROR = "error"
STATUS_UNAVAILABLE = "unavailable"       # primary failed / circuit open
STATUS_SHUTDOWN = "shutdown"
#: input guard refusal: non-finite / wildly out-of-range features under
#: the ``reject`` policy — a 400, not a 503, so NOT a degraded status (a
#: made-up answer to a garbage question helps nobody)
STATUS_INVALID_INPUT = "invalid_input"
#: a full-quality answer scored by a CANDIDATE model during a canary
#: traffic split — ``ok`` is True; the tag attributes the answer
STATUS_CANARY = "canary"

#: statuses answered by the fallback path (degraded but not failed)
DEGRADED_STATUSES = (
    STATUS_REJECTED, STATUS_DEADLINE_EXCEEDED, STATUS_UNAVAILABLE,
)


@dataclass
class ServeResult:
    """What a client gets back — always, and promptly: every admission
    path ends in exactly one ``ServeResult``, never a hang."""

    value: Optional[np.ndarray]
    status: str = STATUS_OK
    latency_s: float = 0.0
    degraded: bool = False
    detail: str = ""

    @property
    def ok(self) -> bool:
        # canary answers are full-quality predictions (attributed to the
        # candidate model), not a degradation
        return self.status in (STATUS_OK, STATUS_CANARY)


@dataclass
class Request:
    """One admitted unit of work (1..top-bucket rows) plus its rendezvous."""

    x: np.ndarray
    enqueued_at: float
    deadline: float | None  # absolute monotonic seconds, None = patient
    _event: threading.Event = field(default_factory=threading.Event)
    _result: ServeResult | None = None

    @property
    def rows(self) -> int:
        return self.x.shape[0]

    def expired(self, now: float | None = None) -> bool:
        return self.deadline is not None and (now or time.monotonic()) >= self.deadline

    # rendezvous ---------------------------------------------------------
    def complete(self, result: ServeResult) -> None:
        result.latency_s = time.monotonic() - self.enqueued_at
        self._result = result
        self._event.set()

    def wait(self, timeout: float | None = None) -> ServeResult:
        if not self._event.wait(timeout):
            return ServeResult(
                None, STATUS_DEADLINE_EXCEEDED,
                latency_s=time.monotonic() - self.enqueued_at,
                detail="client wait timed out",
            )
        assert self._result is not None
        return self._result


class RequestQueue:
    """Row-bounded FIFO with shed-at-admission semantics."""

    def __init__(self, max_rows: int | None = None):
        # None → the registry's serve.queue.max_rows
        if max_rows is None:
            max_rows = int(knob("serve.queue.max_rows"))
        if max_rows < 1:
            raise ValueError("max_rows must be positive")
        self.max_rows = max_rows
        self._q: deque[Request] = deque()
        self._rows = 0
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)

    # ------------------------------------------------------------ admit
    def offer(self, req: Request) -> bool:
        """Admit or refuse immediately — never blocks.  False means the
        queue is saturated (caller sheds/falls back)."""
        with self._not_empty:
            if self._rows + req.rows > self.max_rows:
                return False
            self._q.append(req)
            self._rows += req.rows
            self._not_empty.notify()
            return True

    # ------------------------------------------------------------ drain
    def take(
        self, max_rows: int, wait_s: float | None, more_wait_s: float = 0.0
    ) -> list[Request]:
        """Pop a coalesced run of requests totalling ≤ ``max_rows`` rows.

        Blocks up to ``wait_s`` for the FIRST request (None = forever);
        after one arrives, lingers up to ``more_wait_s`` for followers
        while capacity remains — the micro-batching window.  Expired
        requests are popped too (the batcher answers them degraded);
        a request that would overflow ``max_rows`` stays queued for the
        next batch."""
        batch: list[Request] = []
        got = 0
        deadline = None if wait_s is None else time.monotonic() + wait_s
        with self._not_empty:
            while not self._q:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return batch
                self._not_empty.wait(remaining)
            linger_until = time.monotonic() + more_wait_s
            while True:
                while self._q and got + self._q[0].rows <= max_rows:
                    r = self._q.popleft()
                    self._rows -= r.rows
                    got += r.rows
                    batch.append(r)
                if got >= max_rows or more_wait_s <= 0:
                    break
                remaining = linger_until - time.monotonic()
                if remaining <= 0 or (self._q and got + self._q[0].rows > max_rows):
                    break
                self._not_empty.wait(remaining)
        return batch

    # ------------------------------------------------------------ stats
    @property
    def depth_rows(self) -> int:
        with self._lock:
            return self._rows

    def drain_all(self) -> list[Request]:
        """Pop everything (shutdown path)."""
        with self._lock:
            out = list(self._q)
            self._q.clear()
            self._rows = 0
            return out

    def wake_all(self) -> None:
        with self._not_empty:
            self._not_empty.notify_all()

"""Adaptive micro-batcher: single rows in, padded bucket batches out.

Coalesces REQUESTS into padded device batches.  The latency budget is
milliseconds, so the coalescing window adapts:

* queue deep (≥ one full top bucket waiting): fire immediately — waiting
  cannot improve fill, only tail latency;
* queue shallow: linger up to ``max_wait_s`` for followers, trading a
  bounded latency add for batch fill (the setting that decides whether
  the card sees 1-row or 64-row batches).

Every admitted request is answered exactly once (see ``queue.py``); the
degradation ladder (shed at admission, drop at deadline, fallback answer
when configured) lives here because only the batcher knows *when* a
request finally reaches the device.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Union

import numpy as np

from .metrics import ServingMetrics
from .queue import (
    DEFAULT_MAX_QUEUE_ROWS,
    DEGRADED_STATUSES,
    Request,
    RequestQueue,
    ServeResult,
    STATUS_DEADLINE_EXCEEDED,
    STATUS_OK,
    STATUS_REJECTED,
    STATUS_SHUTDOWN,
    STATUS_UNAVAILABLE,
)
from .registry import ServingModel

log = logging.getLogger(__name__)

#: default linger for followers when the queue is shallow — 2 ms buys
#: coalescing at realistic arrival rates without a visible latency bump
DEFAULT_MAX_WAIT_S = 0.002

Fallback = Union["ServingModel", Callable[[np.ndarray], np.ndarray], None]


class MicroBatcher:
    """Background worker that serves a :class:`ServingModel` from a
    bounded request queue with adaptive coalescing.

    ``fallback`` handles degraded answers: a cheaper :class:`ServingModel`
    (or any ``rows -> predictions`` callable, e.g. a class prior) whose
    output is returned with ``degraded=True`` instead of a bare 503-style
    refusal.  The fallback runs on the CALLER's thread — it must be cheap
    by construction, and a saturated main queue must not serialize sheds
    behind itself.
    """

    def __init__(
        self,
        model: ServingModel,
        max_queue_rows: int = DEFAULT_MAX_QUEUE_ROWS,
        max_wait_s: float = DEFAULT_MAX_WAIT_S,
        fallback: Fallback = None,
        metrics: ServingMetrics | None = None,
    ):
        self.model = model
        self.metrics = metrics or model.metrics
        self.queue = RequestQueue(max_rows=max_queue_rows)
        self.max_wait_s = float(max_wait_s)
        self.fallback = fallback
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "MicroBatcher":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="serve-microbatcher", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the worker (the batch in flight finishes — the join covers
        one device call); still-queued requests are answered ``shutdown``
        rather than stranded."""
        self._stop.set()
        self.queue.wake_all()
        if self._thread is not None:
            self._thread.join(timeout)
        for req in self.queue.drain_all():
            self._answer_degraded(req, STATUS_SHUTDOWN, "server stopped")

    def __enter__(self) -> "MicroBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ client API
    def submit(
        self,
        x: np.ndarray,
        deadline_s: float | None = None,
    ) -> Request:
        """Admit a request (1..top-bucket rows); returns the
        :class:`Request` whose ``.wait()`` yields the result.  A saturated
        queue answers immediately (``rejected``/fallback) — admission
        NEVER blocks."""
        x = np.asarray(x)
        if x.ndim == 1:
            x = x[None, :]
        top = self.model.buckets[-1]
        if x.shape[0] > top:
            raise ValueError(
                f"{x.shape[0]} rows exceed the top bucket {top}; bulk-score "
                "through serve.scoring instead"
            )
        now = time.monotonic()
        req = Request(
            x=x,
            enqueued_at=now,
            deadline=None if deadline_s is None else now + deadline_s,
        )
        if self._stop.is_set():  # stopped server: answer, don't strand
            self._answer_degraded(req, STATUS_SHUTDOWN, "server stopped")
        elif not self.queue.offer(req):
            self._answer_degraded(req, STATUS_REJECTED, "queue saturated")
        elif self._stop.is_set():
            # stop() ran between the check above and the offer: its drain
            # may have missed this request, so drain again — drain_all is
            # atomic, so each request is answered exactly once either way
            for r in self.queue.drain_all():
                self._answer_degraded(r, STATUS_SHUTDOWN, "server stopped")
        self.metrics.set_queue_depth(self.queue.depth_rows)
        return req

    def predict(
        self, x: np.ndarray, deadline_s: float | None = None,
        wait_timeout_s: float | None = 30.0,
    ) -> ServeResult:
        """Synchronous convenience: submit + wait."""
        return self.submit(x, deadline_s=deadline_s).wait(wait_timeout_s)

    # ------------------------------------------------------------ worker
    def _run(self) -> None:
        top = self.model.buckets[-1]
        while not self._stop.is_set():
            # adaptive window: deep queue → take a full bucket now;
            # shallow queue → linger for followers
            linger = 0.0 if self.queue.depth_rows >= top else self.max_wait_s
            batch = self.queue.take(top, wait_s=0.05, more_wait_s=linger)
            if not batch:
                continue
            self.metrics.set_queue_depth(self.queue.depth_rows)
            now = time.monotonic()
            live = [r for r in batch if not r.expired(now)]
            for r in batch:
                if r.expired(now):
                    self._answer_degraded(
                        r, STATUS_DEADLINE_EXCEEDED, "expired while queued"
                    )
            if not live:
                continue
            self._execute(live)

    def _execute(self, live: list[Request]) -> None:
        rows = np.concatenate([r.x for r in live], axis=0)
        try:
            preds = self.model.predict_bucketed(rows)
        except Exception as e:  # noqa: BLE001 — a poisoned batch must
            # answer every waiter, not kill the worker thread
            self.metrics.record_primary_failure()
            log.error("batch predict failed (%d rows): %r", rows.shape[0], e)
            for r in live:
                self._answer_degraded(r, STATUS_UNAVAILABLE, repr(e))
            return
        s = 0
        for r in live:
            r.complete(ServeResult(preds[s : s + r.rows], STATUS_OK))
            self.metrics.record_request(
                time.monotonic() - r.enqueued_at, STATUS_OK
            )
            s += r.rows

    # ------------------------------------------------------------ degrade
    def _answer_degraded(self, req: Request, status: str, detail: str) -> None:
        value = None
        degraded = False
        if self.fallback is not None and status in DEGRADED_STATUSES:
            try:
                fb = self.fallback
                value = (
                    fb.predict(req.x) if isinstance(fb, ServingModel)
                    else np.asarray(fb(req.x))
                )
                degraded = True
            except Exception as e:  # noqa: BLE001 — degradation must not raise
                log.warning("fallback failed: %r", e)
        if degraded:
            self.metrics.record_fallback_answer()
        req.complete(
            ServeResult(value, status, degraded=degraded, detail=detail)
        )
        self.metrics.record_request(
            time.monotonic() - req.enqueued_at, status
        )

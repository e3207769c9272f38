"""Stall watchdog: turn a hang into a named, dumped failure.

A soak run (or any long-lived fleet) can wedge in ways no exception
reports: a batcher thread deadlocks, a source stops producing, a view
refresh spins without committing.  Under a test suite that reads as
"the suite hung until its timeout" — zero diagnostics.  The watchdog
converts that failure mode into a bounded one: every subsystem registers
a *progress reading* (any monotone counter it bumps while doing work —
journal appends, served requests, committed batches), a background
thread samples them, and a source whose reading stops changing for a
configurable wall-clock window while it still *has* work is declared
stalled — flight-recorder dump naming the stalled stage, then a
:class:`StallError` raised in the driver thread at its next
:meth:`~StallWatchdog.check`.

Idle is not a stall: a source may register ``busy_fn`` returning whether
it currently has outstanding work (queue depth > 0, run in progress);
with no ``busy_fn`` the source is treated as always-busy, which is the
right reading for a driver loop that should be making progress whenever
the watchdog is armed.

The monitor thread never raises into anyone else's stack — it records
the verdict and dumps; the owning thread observes it via ``check()``
(cooperative, like the faults module's discipline) or the optional
``on_stall`` callback (for abort-by-callback wiring).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable

from ...obs import flight_recorder as _flight
from ...utils.logging import get_logger

log = get_logger("serve")


class StallError(RuntimeError):
    """A registered source made no progress for a full window while busy."""

    def __init__(self, stage: str, window_s: float, dump_path: str | None):
        self.stage = stage
        self.window_s = window_s
        self.dump_path = dump_path
        super().__init__(
            f"subsystem {stage!r} made no progress for {window_s:.1f}s "
            f"(postmortem: {dump_path or 'dump failed'})"
        )


@dataclass
class _Source:
    stage: str
    progress_fn: Callable[[], float]
    busy_fn: Callable[[], bool] | None
    last_value: float = 0.0
    last_change: float = 0.0


class StallWatchdog:
    """Samples registered progress readings; declares a stall after
    ``window_s`` of no change while busy.

    Use as a context manager around the monitored run::

        wd = StallWatchdog(window_s=5.0)
        wd.register("stream", lambda: sink.num_rows())
        wd.register("fleet", lambda: fleet.health()["served_requests"],
                    busy_fn=lambda: fleet.load_factor() > 0)
        with wd:
            ... drive ...
            wd.check()   # raises StallError if anything stalled

    A progress reading may be any number that grows (or merely changes)
    while the subsystem works; readings that *raise* are treated as
    no-change (a dying subsystem must not crash the monitor, it should
    be *reported* by it).
    """

    def __init__(
        self,
        window_s: float = 10.0,
        poll_s: float | None = None,
        on_stall: Callable[[StallError], None] | None = None,
    ):
        if window_s <= 0:
            raise ValueError("window_s must be positive")
        self.window_s = float(window_s)
        self.poll_s = float(poll_s) if poll_s else max(window_s / 8.0, 0.02)
        self.on_stall = on_stall
        self._sources: list[_Source] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._verdict: StallError | None = None

    # ------------------------------------------------------------ wiring
    def register(
        self,
        stage: str,
        progress_fn: Callable[[], float],
        busy_fn: Callable[[], bool] | None = None,
    ) -> None:
        now = time.monotonic()
        src = _Source(stage, progress_fn, busy_fn)
        src.last_value = self._read(src)
        src.last_change = now
        with self._lock:
            self._sources.append(src)

    def watch_fleet(self, fleet) -> None:
        """Convenience: monitor a :class:`~.replica_set.ReplicaSet` —
        progress is served requests, busy is rows queued anywhere (an
        idle fleet with empty queues is not stalled, a fleet with queued
        work and no answers is)."""
        self.register(
            "fleet",
            lambda: float(
                fleet.metrics.collect()["counters"].get("serve.requests", 0)
            ),
            busy_fn=lambda: fleet.load_factor() > 0.0,
        )

    # ------------------------------------------------------------ running
    @staticmethod
    def _read(src: _Source) -> float:
        try:
            return float(src.progress_fn())
        except Exception:  # noqa: BLE001 — a dying subsystem reads as stuck
            return src.last_value

    def _busy(self, src: _Source) -> bool:
        if src.busy_fn is None:
            return True
        try:
            return bool(src.busy_fn())
        except Exception:  # noqa: BLE001
            return True

    def _scan(self, now: float) -> None:
        with self._lock:
            sources = list(self._sources)
        for src in sources:
            value = self._read(src)
            if value != src.last_value:
                src.last_value = value
                src.last_change = now
                continue
            if not self._busy(src):
                src.last_change = now  # idle: the no-progress clock resets
                continue
            if now - src.last_change >= self.window_s:
                self._declare(src)
                return

    def _declare(self, src: _Source) -> None:
        dump_path = _flight.notify(
            "stall", "watchdog.stall",
            stage=src.stage, window_s=self.window_s,
            last_progress=src.last_value,
        )
        err = StallError(src.stage, self.window_s, dump_path)
        log.error(
            "watchdog declared stall", stage=src.stage,
            window_s=self.window_s, dump=dump_path,
        )
        with self._lock:
            if self._verdict is None:
                self._verdict = err
        self._stop.set()  # one verdict is the run's verdict; stop sampling
        if self.on_stall is not None:
            try:
                self.on_stall(err)
            except Exception:  # noqa: BLE001 — the callback is advisory
                pass

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            self._scan(time.monotonic())

    def start(self) -> "StallWatchdog":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="stall-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)

    def __enter__(self) -> "StallWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ verdict
    def stalled(self) -> StallError | None:
        with self._lock:
            return self._verdict

    def check(self) -> None:
        """Raise the recorded stall (if any) in the CALLER's thread —
        the cooperative abort point a driver loop polls."""
        err = self.stalled()
        if err is not None:
            raise err

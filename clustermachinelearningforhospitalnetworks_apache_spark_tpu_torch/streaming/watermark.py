"""Event-time watermarking.

Parity with ``withWatermark("event_time", "10 minutes")`` at reference
``mllearnforhospitalnetwork.py:81`` (SURVEY.md C5): the watermark is
``max(event_time seen so far) − delay``; rows arriving with an event time
older than the watermark are late and dropped.  Spark advances the
watermark between micro-batches (a batch is filtered against the watermark
computed from *previous* batches) — same here, so results match Spark's
semantics batch-for-batch.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.table import Table


@dataclass
class WatermarkTracker:
    column: str
    delay_minutes: float
    _max_event_time: np.datetime64 | None = field(default=None)

    @property
    def watermark(self) -> np.datetime64 | None:
        if self._max_event_time is None:
            return None
        delay = np.timedelta64(int(self.delay_minutes * 60 * 1_000_000_000), "ns")
        return self._max_event_time - delay

    def filter_late(self, table: Table) -> tuple[Table, int]:
        """Drop rows older than the current watermark, then advance it.
        Returns (on-time rows, number of late rows dropped)."""
        wm = self.watermark
        times = table.column(self.column)
        if wm is None:
            kept = table
            dropped = 0
        else:
            ok = ~np.isnat(times) & (times >= wm)
            dropped = int((~ok).sum())
            kept = table.mask(ok)
        if len(times):
            valid = times[~np.isnat(times)]
            if valid.size:
                batch_max = valid.max()
                if self._max_event_time is None or batch_max > self._max_event_time:
                    self._max_event_time = batch_max
        return kept, dropped

    def state(self) -> dict:
        return {
            "max_event_time": None
            if self._max_event_time is None
            else str(self._max_event_time)
        }

    def restore(self, state: dict) -> None:
        v = state.get("max_event_time")
        self._max_event_time = None if v is None else np.datetime64(v)

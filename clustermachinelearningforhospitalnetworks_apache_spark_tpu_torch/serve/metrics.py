"""Serving metrics: tail latency, queue depth, batch fill, recompiles.

Counters, gauges and two fixed-bucket histograms (latency, batch fill)
in one small registry per server.  p50/p99 are interpolated from the
latency histogram, the same edges and interpolation as the JAX package's
``obs/registry.py`` ``FixedHistogram``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np

#: latency histogram edges (seconds): log-spaced 100 µs → 10 s, 4 per decade
LATENCY_EDGES_S = tuple(round(10.0 ** (e / 4.0), 6) for e in range(-16, 5))

#: ratio histogram edges (batch fill): uniform on [0, 1]
RATIO_EDGES = tuple(i / 16.0 for i in range(17))

LATENCY_HIST = "serve.latency_seconds"
FILL_HIST = "serve.batch_fill"


class FixedHistogram:
    """Fixed-edge histogram with under/overflow bins and an exact mean."""

    def __init__(self, edges: Sequence[float]):
        self.edges = np.asarray(edges, dtype=np.float64)
        self.counts = np.zeros(self.edges.size + 1, dtype=np.float64)
        self.count = 0.0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        i = int(np.searchsorted(self.edges, value, side="right"))
        if value == self.edges[-1]:  # the top edge closes the last bin
            i = self.edges.size - 1
        self.counts[i] += 1.0
        self.count += 1.0
        self.sum += float(value)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count > 0 else float("nan")

    def quantile(self, q: float) -> float:
        """Interpolated quantile; the open bins get synthetic extents
        (underflow down to 0, overflow one bin width past the top)."""
        total = self.counts.sum()
        if total <= 0:
            return float("nan")
        e = self.edges
        lows = np.concatenate([[min(0.0, float(e[0] - (e[1] - e[0])))], e])
        highs = np.concatenate([e, [float(e[-1] + (e[-1] - e[-2]))]])
        cum = np.cumsum(self.counts)
        target = min(max(q, 0.0), 1.0) * total
        i = min(int(np.searchsorted(cum, target)), self.counts.size - 1)
        prev = cum[i - 1] if i > 0 else 0.0
        frac = 0.0 if self.counts[i] == 0 else (target - prev) / self.counts[i]
        return float(lows[i] + frac * (highs[i] - lows[i]))


@dataclass
class ServingMetrics:
    """Thread-safe serving-side metrics sink, one per server."""

    counters: dict = field(default_factory=dict)
    gauges: dict = field(default_factory=dict)
    histograms: dict = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def _inc(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def _observe(self, name: str, value: float, edges) -> None:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = FixedHistogram(edges)
        h.observe(value)

    # ------------------------------------------------------------ record
    def record_request(self, latency_s: float, status: str = "ok") -> None:
        with self._lock:
            self._inc("serve.requests")
            self._inc(f"serve.status.{status}")
            self._observe(LATENCY_HIST, latency_s, LATENCY_EDGES_S)

    def record_batch(self, n_valid: int, bucket: int) -> None:
        with self._lock:
            self._inc("serve.batches")
            self._inc("serve.rows", float(n_valid))
            self._inc("serve.padded_rows", float(bucket - n_valid))
            self._observe(FILL_HIST, n_valid / bucket if bucket else 0.0,
                          RATIO_EDGES)

    def record_compile(self, bucket: int, warm: bool) -> None:
        """``warm`` marks planned warmup shapes; anything else is a shape
        first met on the request path — the number that must read 0."""
        with self._lock:
            self._inc("serve.warmup_compiles" if warm else "serve.recompiles")

    def record_primary_failure(self) -> None:
        with self._lock:
            self._inc("serve.primary_failures")

    def record_fallback_answer(self) -> None:
        with self._lock:
            self._inc("serve.fallback_answers")

    def set_queue_depth(self, rows: int) -> None:
        with self._lock:
            self.gauges["serve.queue_depth_rows"] = float(rows)
            if rows > self.gauges.get("serve.queue_depth_peak", 0.0):
                self.gauges["serve.queue_depth_peak"] = float(rows)

    # ------------------------------------------------------------ read
    def percentile(self, q: float) -> float | None:
        """Histogram-interpolated latency percentile (``q`` in 0..100)."""
        with self._lock:
            h = self.histograms.get(LATENCY_HIST)
            if h is None or h.count <= 0:
                return None
            return max(h.quantile(q / 100.0), 0.0)

    def batch_fill_ratio(self) -> float | None:
        with self._lock:
            h = self.histograms.get(FILL_HIST)
            return None if h is None or h.count <= 0 else float(h.mean)

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            c = dict(self.counters)
            g = dict(self.gauges)
        out = {
            "requests": int(c.get("serve.requests", 0)),
            "batches": int(c.get("serve.batches", 0)),
            "rows": int(c.get("serve.rows", 0)),
            "warmup_compiles": int(c.get("serve.warmup_compiles", 0)),
            "recompiles": int(c.get("serve.recompiles", 0)),
            "queue_depth_rows": g.get("serve.queue_depth_rows", 0.0),
            "queue_depth_peak": g.get("serve.queue_depth_peak", 0.0),
            "primary_failures": int(c.get("serve.primary_failures", 0)),
            "fallback_answers": int(c.get("serve.fallback_answers", 0)),
            "statuses": {
                k.split(".", 2)[2]: int(v)
                for k, v in c.items() if k.startswith("serve.status.")
            },
        }
        p50, p99 = self.percentile(50), self.percentile(99)
        if p50 is not None:
            out["latency_p50_ms"] = round(p50 * 1e3, 3)
            out["latency_p99_ms"] = round(p99 * 1e3, 3)
        fill = self.batch_fill_ratio()
        if fill is not None:
            out["batch_fill_ratio"] = round(fill, 4)
        return out

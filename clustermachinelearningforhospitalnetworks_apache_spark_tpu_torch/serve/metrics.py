"""Serving metrics: tail latency, queue depth, batch fill, recompiles.

Rides :mod:`..obs.registry` — the port's one metrics surface — so serve
counters, gauges and distributions live in the same ``MetricsRegistry``
the exporters read and the streaming layer feeds (``.registry``).  The
latency and batch-fill distributions are fixed-bucket mergeable
histograms (``obs.registry.FixedHistogram``): p50/p99 come from bounded
state that merges exactly across replicas, ``_sum/_count`` keep the
exact mean, and the Prometheus exporter gets real ``_bucket`` series.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any

from ..obs.registry import (
    LATENCY_EDGES_S,
    MetricsRegistry,
    RATIO_EDGES,
)

#: registry keys for the two serving distributions
LATENCY_HIST = "serve.latency_seconds"
FILL_HIST = "serve.batch_fill"


@dataclass
class ServingMetrics:
    """Thread-safe serving-side metrics sink.

    Each sink owns its registry by default, so two servers (or two test
    cases) never bleed counters into each other; pass
    ``utils.metrics.global_metrics()`` explicitly to fold serve counters
    into the process-wide registry, or let :class:`~.server
    .InferenceServer` register its pull-collector on the global one.
    """

    registry: MetricsRegistry = field(default_factory=MetricsRegistry)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    # ------------------------------------------------------------ record
    def record_request(self, latency_s: float, status: str = "ok") -> None:
        with self._lock:
            self.registry.inc("serve.requests")
            self.registry.inc(f"serve.status.{status}")
            self.registry.observe(LATENCY_HIST, latency_s, LATENCY_EDGES_S)

    def record_batch(self, n_valid: int, bucket: int) -> None:
        with self._lock:
            self.registry.inc("serve.batches")
            self.registry.inc("serve.rows", float(n_valid))
            self.registry.inc("serve.padded_rows", float(bucket - n_valid))
            self.registry.observe(
                FILL_HIST, n_valid / bucket if bucket else 0.0, RATIO_EDGES
            )

    def record_compile(self, bucket: int, warm: bool) -> None:
        """``warm`` marks planned warmup compiles; anything else is a
        steady-state recompile — the number that must read 0."""
        with self._lock:
            self.registry.inc(
                "serve.warmup_compiles" if warm else "serve.recompiles"
            )

    def record_primary_failure(self) -> None:
        """A primary-model executable raised — the breaker's raw signal."""
        with self._lock:
            self.registry.inc("serve.primary_failures")

    def record_fallback_answer(self) -> None:
        """A degraded request was answered by the fallback path."""
        with self._lock:
            self.registry.inc("serve.fallback_answers")

    def record_inputs_imputed(self, n: int) -> None:
        """The input guard repaired ``n`` bad cells of one request.  The
        guard runs on each client's thread, so every guard counter goes
        through ``_lock`` like the rest."""
        with self._lock:
            self.registry.inc("serve.inputs_imputed", n)

    def record_input_rejected(self) -> None:
        with self._lock:
            self.registry.inc("serve.inputs_rejected")

    def record_drift_trip(self) -> None:
        with self._lock:
            self.registry.inc("serve.drift_trips")

    def record_breaker_transition(self, old: str, new: str) -> None:
        with self._lock:
            self.registry.inc("serve.breaker_transitions")
            self.registry.inc(f"serve.breaker.to_{new}")

    def set_queue_depth(self, rows: int) -> None:
        with self._lock:
            self.registry.set("serve.queue_depth_rows", float(rows))
            peak = self.registry.gauges.get("serve.queue_depth_peak", 0.0)
            if rows > peak:
                self.registry.set("serve.queue_depth_peak", float(rows))

    # ------------------------------------------------------------ read
    @property
    def recompile_count(self) -> int:
        return int(self.registry.counters.get("serve.recompiles", 0))

    def percentile(self, q: float) -> float | None:
        """Histogram-interpolated latency percentile (``q`` in 0..100)."""
        h = self.registry.histograms.get(LATENCY_HIST)
        if h is None or h.count <= 0:
            return None
        return max(h.quantile(q / 100.0), 0.0)

    def batch_fill_ratio(self) -> float | None:
        """Exact mean real-rows fraction (histogram ``sum/count``)."""
        h = self.registry.histograms.get(FILL_HIST)
        if h is None or h.count <= 0:
            return None
        return float(h.mean)

    def snapshot(self) -> dict[str, Any]:
        c = self.registry.counters
        out = {
            "requests": int(c.get("serve.requests", 0)),
            "batches": int(c.get("serve.batches", 0)),
            "rows": int(c.get("serve.rows", 0)),
            "warmup_compiles": int(c.get("serve.warmup_compiles", 0)),
            "recompiles": self.recompile_count,
            "queue_depth_rows": self.registry.gauges.get(
                "serve.queue_depth_rows", 0.0
            ),
            "queue_depth_peak": self.registry.gauges.get(
                "serve.queue_depth_peak", 0.0
            ),
            "primary_failures": int(c.get("serve.primary_failures", 0)),
            "fallback_answers": int(c.get("serve.fallback_answers", 0)),
            "breaker_transitions": int(c.get("serve.breaker_transitions", 0)),
            "statuses": {
                k.split(".", 2)[2]: int(v)
                for k, v in c.items()
                if k.startswith("serve.status.")
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

"""Unified observability fabric: metrics, tracing, postmortem capture.

One place to ask "where did this request/batch/retrain spend its time,
and what was the system doing when it broke":

* :mod:`registry` — process-global :class:`~.registry.MetricsRegistry`
  of counters / gauges / fixed-bucket mergeable histograms; every
  subsystem's metric source lands here (``serve.*``, ``stream.*``,
  ``sql.*``, drift PSI, breaker states, lifecycle phase) either by
  writing directly or through a registered pull-collector.
* :mod:`trace`    — span-based tracing threaded through the real
  unit-of-work chain (streaming batch → SQL fingerprint → fit stages →
  serve request → lifecycle transition), emitted as JSONL spans with
  the WAL append/torn-tail discipline; near-zero cost uninstalled
  (the ``utils/faults.py`` uninstalled-site discipline).
* :mod:`export`   — Prometheus-text and JSON snapshot exporters over
  the registry (the schema downstream scrapers pin on).
* :mod:`flight_recorder` — bounded ring of recent spans/metric marks,
  dumped atomically (CRC32C) on breaker trip, quarantine, lifecycle
  rollback, or :class:`~..utils.faults.InjectedCrash` — every chaos
  kill leaves a postmortem artifact.

This ``__init__`` stays import-light on purpose: ``utils/metrics.py``
(imported by nearly everything) shims onto :mod:`registry`, so pulling
the sibling submodules in eagerly here would cycle back through
``streaming``/``serve``.  They load lazily on first attribute access.
"""

from __future__ import annotations

from . import registry
from .registry import FixedHistogram, MetricsRegistry, global_registry

_LAZY = ("trace", "export", "flight_recorder")

__all__ = [
    "FixedHistogram",
    "MetricsRegistry",
    "global_registry",
    "registry",
    *_LAZY,
]


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

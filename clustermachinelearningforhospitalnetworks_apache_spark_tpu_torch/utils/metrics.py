"""The metrics registry under its older import path: a re-export of
:mod:`..obs.registry`, the port's one metrics surface (as the JAX
package's ``utils/metrics.py`` re-exports its ``obs/registry.py``)."""

from __future__ import annotations

from ..obs.registry import (  # noqa: F401 — re-exported public surface
    FixedHistogram,
    MetricsRegistry,
    StageTiming,
    global_registry,
)

__all__ = [
    "FixedHistogram",
    "MetricsRegistry",
    "StageTiming",
    "global_metrics",
    "global_registry",
]


def global_metrics() -> MetricsRegistry:
    """The process-global registry (``obs.registry.global_registry``)."""
    return global_registry()

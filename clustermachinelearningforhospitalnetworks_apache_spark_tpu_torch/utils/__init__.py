"""Host-side utilities: deterministic fault injection, structured logging,
the metrics registry and retries (the JAX package's ``utils/faults.py``,
``logging.py``, ``metrics.py`` and ``retry.py``)."""

from .faults import FaultError, FaultPlan, InjectedCrash, fault_point
from .logging import Logger, configure_logging, get_logger
from .metrics import MetricsRegistry, StageTiming, global_metrics
from .retry import RetryPolicy, call_with_retry

__all__ = [
    "FaultError", "FaultPlan", "InjectedCrash", "Logger", "MetricsRegistry", "RetryPolicy",
    "StageTiming", "call_with_retry", "configure_logging", "fault_point", "get_logger",
    "global_metrics",
]

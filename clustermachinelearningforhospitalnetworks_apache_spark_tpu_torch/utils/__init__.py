"""Host-side utilities: deterministic fault injection, structured logging,
the metrics registry, retries and the profiling hooks (the JAX package's
``utils/faults.py``, ``logging.py``, ``metrics.py``, ``retry.py`` and
``profiling.py``, the last over ``torch.profiler``)."""

from .faults import FaultError, FaultPlan, InjectedCrash, fault_point
from .logging import Logger, configure_logging, get_logger
from .metrics import MetricsRegistry, StageTiming, global_metrics
from .profiling import block_until_ready, capture_trace, device_fence, trace_annotation
from .retry import RetryPolicy, call_with_retry

__all__ = [
    "FaultError", "FaultPlan", "InjectedCrash", "Logger", "MetricsRegistry", "RetryPolicy",
    "StageTiming", "block_until_ready", "call_with_retry", "capture_trace", "configure_logging",
    "device_fence", "fault_point", "get_logger", "global_metrics", "trace_annotation",
]

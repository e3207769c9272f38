"""Host-side utilities: deterministic fault injection and structured
logging (the JAX package's ``utils/faults.py`` and ``utils/logging.py``)."""

from .faults import FaultError, FaultPlan, InjectedCrash, fault_point
from .logging import Logger, configure_logging, get_logger

__all__ = [
    "FaultError",
    "FaultPlan",
    "InjectedCrash",
    "fault_point",
    "Logger",
    "configure_logging",
    "get_logger",
]

"""Online serving: shape buckets, bounded queue, micro-batcher, circuit
breaker, server (with tenant routing and the lifecycle hooks), bulk
scoring, and the serving fleet (:mod:`.fleet`)."""

from .batcher import DEFAULT_MAX_WAIT_S, MicroBatcher
from .breaker import STATE_CLOSED, STATE_HALF_OPEN, STATE_OPEN, CircuitBreaker
from .bucketing import DEFAULT_BUCKETS, bucket_for, fill_ratio, pad_to_bucket
from .metrics import ServingMetrics
from .queue import (
    DEFAULT_MAX_QUEUE_ROWS,
    DEGRADED_STATUSES,
    STATUS_CANARY,
    STATUS_DEADLINE_EXCEEDED,
    STATUS_ERROR,
    STATUS_INVALID_INPUT,
    STATUS_OK,
    STATUS_REJECTED,
    STATUS_SHUTDOWN,
    STATUS_UNAVAILABLE,
    Request,
    RequestQueue,
    ServeResult,
)
from .registry import ModelRegistry, ServingModel
from .scoring import ShardedScorer, bulk_score
from .server import InferenceServer, NotRoutableError
from . import fleet

__all__ = [
    "CircuitBreaker", "DEFAULT_BUCKETS", "DEFAULT_MAX_QUEUE_ROWS", "DEFAULT_MAX_WAIT_S",
    "DEGRADED_STATUSES", "InferenceServer", "MicroBatcher", "ModelRegistry", "NotRoutableError",
    "Request",
    "RequestQueue", "STATE_CLOSED", "STATE_HALF_OPEN", "STATE_OPEN",
    "STATUS_CANARY", "STATUS_DEADLINE_EXCEEDED", "STATUS_ERROR", "STATUS_INVALID_INPUT",
    "STATUS_OK", "STATUS_REJECTED", "STATUS_SHUTDOWN", "STATUS_UNAVAILABLE", "ServeResult",
    "ServingMetrics", "ServingModel", "ShardedScorer", "bucket_for", "bulk_score",
    "fill_ratio", "fleet", "pad_to_bucket",
]

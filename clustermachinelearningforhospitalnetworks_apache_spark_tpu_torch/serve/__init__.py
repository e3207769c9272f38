"""Online serving: shape buckets, bounded queue, micro-batcher, server,
bulk scoring."""

from .batcher import DEFAULT_MAX_WAIT_S, MicroBatcher
from .bucketing import DEFAULT_BUCKETS
from .metrics import ServingMetrics
from .queue import (
    DEFAULT_MAX_QUEUE_ROWS,
    STATUS_DEADLINE_EXCEEDED,
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
from .server import InferenceServer

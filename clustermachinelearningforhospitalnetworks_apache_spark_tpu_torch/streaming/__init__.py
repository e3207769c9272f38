"""Streaming ingest: the file source, the event-time watermark, the
exactly-once checkpoint, the micro-batch loop and its pipelined variant
(``pipeline.py``: a prefetch worker parses and firewalls batch N+1 while
the commit thread updates the model with batch N), and the unbounded
table it appends to (with its sealed segments), over the shared
JSON-lines write-ahead log (``wal.py``)."""

from .checkpoint import StreamCheckpoint
from .microbatch import BATCH_OK, BATCH_QUARANTINED, BatchInfo, StreamExecution
from .pipeline import ModelUpdateConsumer, PipelinedStreamExecution, Prefetched
from .source import FileStreamSource
from .unbounded_table import DiskBudgetExceeded, UnboundedTable
from .watermark import WatermarkTracker

__all__ = [
    "BATCH_OK",
    "BATCH_QUARANTINED",
    "BatchInfo",
    "DiskBudgetExceeded",
    "FileStreamSource",
    "ModelUpdateConsumer",
    "PipelinedStreamExecution",
    "Prefetched",
    "StreamCheckpoint",
    "StreamExecution",
    "UnboundedTable",
    "WatermarkTracker",
]

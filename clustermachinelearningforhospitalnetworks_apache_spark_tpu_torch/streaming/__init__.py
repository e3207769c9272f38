"""Streaming ingest: the file source, the event-time watermark, the
exactly-once checkpoint, the micro-batch loop and the unbounded table
it appends to, over the shared JSON-lines write-ahead log (``wal.py``).
The pipelined loop (``streaming/pipeline.py`` in the JAX package) comes
with slice 7 of the port."""

from .checkpoint import StreamCheckpoint
from .microbatch import BATCH_OK, BATCH_QUARANTINED, BatchInfo, StreamExecution
from .source import FileStreamSource
from .unbounded_table import DiskBudgetExceeded, SealedSegmentsNotPorted, UnboundedTable
from .watermark import WatermarkTracker

__all__ = [
    "BATCH_OK",
    "BATCH_QUARANTINED",
    "BatchInfo",
    "DiskBudgetExceeded",
    "FileStreamSource",
    "SealedSegmentsNotPorted",
    "StreamCheckpoint",
    "StreamExecution",
    "UnboundedTable",
    "WatermarkTracker",
]

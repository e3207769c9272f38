"""Streaming: the JSON-lines write-ahead-log helpers (``wal.py``) that the
span log flushes through.  The sources, watermarks, checkpoint,
micro-batches and the unbounded table come with a later slice of the
port."""

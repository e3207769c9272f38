"""Session — the ``SparkSession`` analogue (the JAX package's
``session.py``, on one device in place of the mesh).

The reference bootstraps ``SparkSession.builder.appName(...).master(
"spark://…").getOrCreate()`` (``mllearnforhospitalnetwork.py:55-58``) and
then uses it for streaming reads (:75) and SQL (:128).  Here a Session
is an in-process object: it owns the device (default the card), a
named-table registry and the fluent streaming read/write surface, with
the builder chain, so reference code ports line for line::

    spark = Session.builder.app_name("x").get_or_create()
    sdf = (spark.read_stream.schema(schema).csv(path)
                 .with_watermark("event_time", "10 minutes"))
    q = (sdf.write_stream.foreach_batch(fn)
            .option("checkpointLocation", ckpt).table("events"))
    q.process_available()          # or q.await_termination(timeout)
    train = spark.sql("SELECT * FROM events WHERE event_time BETWEEN "
                      "'2025-03-31 22:00:00' AND '2025-03-31 23:00:00'")

Materialized views (``create_view``) come with slice 6 of the port, the
fused SQL-to-device path (``sql_to_device``) with slice 5c.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Callable

from .config import PipelineConfig
from .core.schema import Schema
from .core.table import Table
from .device import resolve_device
from .streaming.checkpoint import StreamCheckpoint
from .streaming.microbatch import BatchInfo, StreamExecution
from .streaming.source import FileStreamSource
from .streaming.unbounded_table import UnboundedTable
from .streaming.watermark import WatermarkTracker
from .utils.logging import get_logger
from .utils.metrics import MetricsRegistry

log = get_logger("session")

_DURATION = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*(second|minute|hour|day)s?\s*$")


def parse_duration_minutes(text: str) -> float:
    """'10 minutes' → 10.0 (Spark interval-string parity)."""
    m = _DURATION.match(text)
    if not m:
        raise ValueError(f"cannot parse duration {text!r}")
    value, unit = float(m.group(1)), m.group(2)
    return value * {"second": 1 / 60, "minute": 1, "hour": 60, "day": 1440}[unit]


# ------------------------------------------------------------------ session
_ACTIVE_SESSION: "Session | None" = None


class Session:
    def __init__(self, config: PipelineConfig | None = None, device=None):
        global _ACTIVE_SESSION
        self.config = config or PipelineConfig()
        self.device = resolve_device(device)
        # remember what we displaced, so stop() restores it rather than
        # nulling the slot out from under another session
        self._prev_active_session = _ACTIVE_SESSION
        self.metrics = MetricsRegistry()
        self._tables: dict[str, Any] = {}
        self._streams: list[StreamExecution] = []
        _ACTIVE_SESSION = self

    # builder ----------------------------------------------------------
    class _Builder:
        def __init__(self) -> None:
            self._config = PipelineConfig()
            self._device = None

        def app_name(self, name: str) -> "Session._Builder":
            self._config = self._config.replace(app_name=name)
            return self

        appName = app_name  # Spark spelling

        def device(self, device) -> "Session._Builder":
            self._device = device
            return self

        def get_or_create(self) -> "Session":
            """Spark semantics: reuse the active session if one exists
            (builder config is then ignored, as in Spark)."""
            if _ACTIVE_SESSION is not None:
                return _ACTIVE_SESSION
            return Session(self._config, device=self._device)

        getOrCreate = get_or_create

    class _BuilderAccessor:
        """Fresh builder per access, so chained configs never leak
        between sessions."""

        def __get__(self, obj, objtype=None) -> "Session._Builder":
            return Session._Builder()

    # tables ------------------------------------------------------------
    def register_table(self, name: str, table: Table | UnboundedTable) -> None:
        self._tables[name] = table

    def table(self, name: str) -> Table:
        t = self._tables.get(name)
        if t is None:
            raise KeyError(f"unknown table {name!r}; registered: {sorted(self._tables)}")
        return t.read() if isinstance(t, UnboundedTable) else t

    def sql(self, query: str) -> Table:
        """SQL over registered tables (``core/sql.py``): fully supported
        single-table plans run compiled, as torch ops over the table's
        columns on the session's device; the rest runs on the numpy
        interpreter (``sql_explain`` shows which, and why, per plan
        node)."""
        from .core.sql import execute

        return execute(query, self.table, device=self.device)

    def sql_explain(self, query: str) -> dict:
        """Planner view of ``query`` without running it: the route
        (compiled | interpreter), the plan fingerprint and every plan
        node's supported/fallback decision."""
        from .core.sql import explain

        return explain(query, self.table)

    # streaming read ----------------------------------------------------
    @property
    def read_stream(self) -> "StreamingReader":
        return StreamingReader(self)

    readStream = read_stream

    def stop(self) -> None:
        global _ACTIVE_SESSION
        # release the active slot only if it is still ours — a non-LIFO
        # stop must not clobber another live session's
        if _ACTIVE_SESSION is self:
            _ACTIVE_SESSION = self._prev_active_session
        log.info("session stopped", app=self.config.app_name)


Session.builder = Session._BuilderAccessor()


# --------------------------------------------------- fluent streaming layer
@dataclass
class StreamingReader:
    session: Session
    _schema: Schema | None = None
    _header: bool = True

    def schema(self, s: Schema) -> "StreamingReader":
        self._schema = s
        return self

    def option(self, key: str, value: Any) -> "StreamingReader":
        if key.lower() == "header":
            self._header = str(value).lower() in ("1", "true", "yes")
        return self

    def csv(self, path: str) -> "StreamingFrame":
        if self._schema is None:
            raise ValueError("streaming CSV requires an explicit schema (as in the reference :64-80)")
        return StreamingFrame(
            session=self.session,
            source=FileStreamSource(path, self._schema, header=self._header),
        )


@dataclass
class StreamingFrame:
    session: Session
    source: FileStreamSource
    watermark: WatermarkTracker | None = None

    def with_watermark(self, column: str, delay: str) -> "StreamingFrame":
        self.watermark = WatermarkTracker(column, parse_duration_minutes(delay))
        return self

    withWatermark = with_watermark

    @property
    def write_stream(self) -> "StreamWriter":
        return StreamWriter(frame=self)

    writeStream = write_stream


@dataclass
class StreamWriter:
    frame: StreamingFrame
    _foreach: Callable[[Table, int], None] | None = None
    _options: dict[str, str] = field(default_factory=dict)

    def foreach_batch(self, fn: Callable[[Table, int], None]) -> "StreamWriter":
        self._foreach = fn
        return self

    foreachBatch = foreach_batch

    def output_mode(self, mode: str) -> "StreamWriter":
        if mode != "append":
            raise ValueError("only append mode is supported (the reference uses append, :113)")
        return self

    outputMode = output_mode

    def format(self, fmt: str) -> "StreamWriter":
        # delta/parquet both map onto the parquet-backed unbounded table
        return self

    def option(self, key: str, value: str) -> "StreamWriter":
        self._options[key] = value
        return self

    def table(self, name: str) -> "StreamingQuery":
        session = self.frame.session
        ckpt_path = self._options.get("checkpointLocation", session.config.checkpoint_location)
        sink_dir = self._options.get("path", ckpt_path + "_table_" + name)
        sink = UnboundedTable(sink_dir, self.frame.source.schema, name=name)
        execution = StreamExecution(
            source=self.frame.source,
            sink=sink,
            checkpoint=StreamCheckpoint(ckpt_path),
            watermark=self.frame.watermark,
            foreach_batch=self._foreach,
            device=session.device,
        )
        session.register_table(name, sink)
        session._streams.append(execution)
        return StreamingQuery(execution=execution, name=name)

    def start(self, name: str | None = None) -> "StreamingQuery":
        """Spark-style no-argument start(): the query/table name comes from
        the ``queryName`` option, falling back to a generated name."""
        return self.table(
            name
            or self._options.get("queryName")
            or f"stream_query_{len(self.frame.session._streams)}"
        )


@dataclass
class StreamingQuery:
    execution: StreamExecution
    name: str

    def process_available(self) -> list[BatchInfo]:
        """Drain everything currently in the source (Spark's
        processAllAvailable) — StreamExecution.run's drain-once mode."""
        return self.execution.run()

    processAllAvailable = process_available

    def await_termination(self, timeout_s: float | None = None) -> list[BatchInfo]:
        """Poll-process until the timeout (:117-118's awaitTermination with
        a bound — an unbounded wait would hang a library caller)."""
        if timeout_s is None:
            raise ValueError("await_termination requires a timeout in library use")
        return self.execution.run(timeout_s=timeout_s)

    awaitTermination = await_termination

    @property
    def last_progress(self) -> BatchInfo | None:
        return self.execution.history[-1] if self.execution.history else None

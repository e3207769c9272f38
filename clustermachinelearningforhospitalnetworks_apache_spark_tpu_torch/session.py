"""Session — the ``SparkSession`` analogue (the JAX package's
``session.py``).

The reference bootstraps ``SparkSession.builder.appName(...).master(
"spark://…").getOrCreate()`` (``mllearnforhospitalnetwork.py:55-58``) and
then uses it for streaming reads (:75) and SQL (:128).  Here a Session
is an in-process object: it owns a device mesh and its first device, a
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

The mesh is, in this order: the ``mesh=`` given; else the one-entry mesh
of ``device=``; else ``build_mesh(config.mesh)`` over every card (raising
without one) — ``(1, 1)`` on a one-card machine, today's single-device
path.  It becomes the process's default mesh at construction and
``stop()`` restores the one it displaced, only if the default is still
this session's.  ``session.device`` is the mesh's first device: SQL, the
views and the streams run there, and the model stage fits over the mesh.

``sql_to_device`` is the fused training path: the SQL window, feature
assembly and a ``DeviceDataset`` on the session's device, with no row
passing through the host when the plan compiles.  ``create_view``
registers a materialized view over a streamed table: the stream folds
each committed batch into it, and ``Session.sql`` answers a matching
query from it.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Callable

from .config import PipelineConfig
from .core.schema import Schema
from .core.table import Table
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


def _session_mesh(config: PipelineConfig, device, mesh):
    """The session's mesh: ``mesh``, else the one-entry mesh of ``device``,
    else ``build_mesh(config.mesh)`` over every card.  ``device`` and
    ``mesh`` together must agree: the device is the mesh's first entry's."""
    from .parallel.mesh import build_mesh, single_device_mesh

    if mesh is not None:
        if device is not None and single_device_mesh(device).device(0, 0) != mesh.device(0, 0):
            raise ValueError(f"device {device!r} is not the mesh's first device "
                             f"({mesh.device(0, 0)})")
        return mesh
    if device is not None:
        return single_device_mesh(device)
    return build_mesh(config.mesh)


class Session:
    def __init__(self, config: PipelineConfig | None = None, device=None, mesh=None):
        global _ACTIVE_SESSION
        from .parallel import mesh as _mesh_mod

        self.config = config or PipelineConfig()
        self.mesh = _session_mesh(self.config, device, mesh)
        self.device = self.mesh.device(0, 0)
        # remember what we displaced, so stop() restores it rather than
        # nulling the slot out from under another session
        self._prev_default_mesh = _mesh_mod._DEFAULT_MESH
        _mesh_mod.set_default_mesh(self.mesh)
        self._prev_active_session = _ACTIVE_SESSION
        self.metrics = MetricsRegistry()
        self._tables: dict[str, Any] = {}
        self._streams: list[StreamExecution] = []
        # materialized views: one registry per session, on its device; the
        # streaming commit path maintains them, Session.sql serves from
        # them when a plan fingerprint matches a fresh view
        from .core.sql_views import ViewRegistry

        self.views = ViewRegistry(device=self.device)
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

        def config_obj(self, cfg: PipelineConfig) -> "Session._Builder":
            self._config = cfg
            return self

        def mesh(self, mesh_cfg) -> "Session._Builder":
            """The mesh's shape (a ``MeshConfig``), built over every card."""
            self._config = self._config.replace(mesh=mesh_cfg)
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
        node).  When a registered materialized view matches the plan's
        fingerprint and is fresh, the answer comes from the view's
        delta-maintained state instead of re-executing over the table's
        history (route ``"view"``)."""
        from .core.sql import execute

        return execute(query, self.table, views=self.views, device=self.device)

    def sql_explain(self, query: str) -> dict:
        """Planner view of ``query`` without running it: the route
        (compiled | interpreter), the plan fingerprint, every plan node's
        supported/fallback decision and its incremental decision
        (``incremental`` vs ``full-recompute:<reason>``), and, over an
        unbounded table with sealed segments, the ``prune`` preview."""
        from .core.sql import explain

        return explain(query, self.table)

    def create_view(self, name: str, query: str, watermark=None) -> Any:
        """Register a materialized view over a registered
        :class:`~.streaming.unbounded_table.UnboundedTable`: it is
        maintained per committed batch (mergeable aggregate partials or
        per-batch row deltas, computed on the session's device) and
        ``Session.sql`` answers matching queries from it.  ``watermark``
        (a ``WatermarkTracker``, typically the stream's) enables the
        compaction of aggregate partials sealed below the event-time
        watermark.  Queries outside the incremental subset still register
        but serve loud full recomputes (``sql_explain`` shows why per
        node)."""
        from .core.sql_parse import _Query, parse

        node = parse(query)
        if not isinstance(node, _Query) or not isinstance(node.table[0], str) or node.joins:
            raise ValueError(
                "a materialized view needs a single-table SELECT over a "
                "registered unbounded table"
            )
        source = self._tables.get(node.table[0])
        if not isinstance(source, UnboundedTable):
            raise ValueError(
                f"view {name!r}: {node.table[0]!r} is not a registered "
                "UnboundedTable (views materialize over the streaming "
                "sink; plain tables are already in memory)"
            )
        return self.views.register(name, query, source, watermark=watermark)

    def sql_to_device(self, query: str, feature_cols=None, label_col: str | None = None,
                      mesh=None, na_drop: bool = True, clock=None, mode: str = "auto"):
        """The fused training path: SQL window → feature assembly → a
        dataset over ``mesh`` (default the session's): a
        :class:`~.data.DeviceDataset` on a one-entry mesh's device, a
        :class:`~.parallel.sharding.ShardedDataset` over a larger one.
        When the plan compiles (a fully supported row-level query without
        LIMIT), the query runs as torch ops over the device column cache on
        the session's device, the assembly stacks its result there
        (``DeviceView.assemble``) and the rows are laid over the mesh
        device to device: no row reaches the host.  Otherwise the
        interpreter (or the compiled aggregate) builds a host Table,
        ``na_drop`` and ``VectorAssembler`` run on the host and the matrix
        transfers once; ``mode="compile"`` raises
        :class:`~.core.sql.SqlCompileUnsupported` instead, and
        ``core.sql.last_dispatch()`` records the route.  ``na_drop``
        mirrors the reference's ``na.drop()`` over the feature and label
        columns.  ``clock``: anything with a ``stage(name)`` context
        manager, opened around ``transfer``, ``sql`` and ``assemble``."""
        from contextlib import nullcontext

        from .core.schema import FEATURE_COLS, LABEL_COL
        from .core.sql import execute
        from .core.sql_compile import compile_rowlevel
        from .features.assembler import VectorAssembler

        mesh = mesh or self.mesh
        feature_cols = tuple(feature_cols or FEATURE_COLS)
        assembler = VectorAssembler(feature_cols)
        view = compile_rowlevel(query, self.table, mode=mode, clock=clock, device=self.device)
        stage = clock.stage if clock is not None else (lambda _: nullcontext())
        if view is not None:
            with stage("assemble"):
                return assembler.transform_device(view, label_col=label_col, mesh=mesh,
                                                  na_drop=na_drop)
        # the host route: one transfer, at to_device.  A fresh
        # fingerprint-matched materialized view answers here too (the
        # fused device route above stays view-free: it never
        # materializes), so the Table may come from folded view state
        # instead of a history re-scan
        with stage("sql"):
            t = execute(query, self.table, views=self.views, device=self.device)
        if label_col is None and LABEL_COL in t.schema:
            label_col = LABEL_COL
        if na_drop:
            t = t.na_drop(subset=list(feature_cols) + ([label_col] if label_col else []))
        with stage("assemble"):
            return assembler.transform(t).to_device(label_col=label_col, mesh=mesh)

    # streaming read ----------------------------------------------------
    @property
    def read_stream(self) -> "StreamingReader":
        return StreamingReader(self)

    readStream = read_stream

    def stop(self) -> None:
        global _ACTIVE_SESSION
        from .parallel import mesh as _mesh_mod

        # restore the displaced default mesh and active slot only if they
        # are still ours — a non-LIFO stop must not clobber another live
        # session's
        if _mesh_mod._DEFAULT_MESH is self.mesh:
            _mesh_mod.set_default_mesh(self._prev_default_mesh)
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
            # the session's materialized views fold each committed
            # batch's delta in on the commit path
            views=session.views,
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

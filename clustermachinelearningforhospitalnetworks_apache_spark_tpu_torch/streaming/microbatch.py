"""Micro-batch stream execution loop (the JAX package's
``streaming/microbatch.py``).

The working equivalent of Spark's StreamExecution loop as the reference
uses it (``writeStream.foreachBatch(ML).format("delta").outputMode
("append").option("checkpointLocation",…).table(…)``,
``mllearnforhospitalnetwork.py:111-118``): every micro-batch is (1)
appended to the unbounded table and (2) handed to an optional per-batch
callback.

Batch lifecycle (exactly-once):
    poll files → WRITE OFFSETS (intent + watermark state) → record attempt
    → read → watermark filter → foreach_batch → append part file →
    WRITE COMMIT → mark files.
A crash after offsets but before commit replays the identical batch on
restart; a crash after commit skips it.

Self-healing: every attempt at a batch is durably counted
(``attempts.log``), so a **poison batch** — one that fails
``max_batch_replays`` times, in-process or by killing the process each
replay — is **quarantined** (evidence under ``<ckpt>/quarantine/``, the
batch committed as skipped); transient failures back off with jitter
between replays; per-file source reads retry on their own (``source.py``).
With a :class:`~..quality.firewall.DataFirewall`, the rung BELOW batch
quarantine is on: malformed / constraint-violating rows are split out per
row (salvage parse + vectorized validation), written to
``<ckpt>/quarantine/rows/`` with reasons, and the rest of the batch goes
on — a bad row costs a row, not a batch (``stream.rows_rejected`` /
``stream.drift_events`` count them; the firewall's drift monitor feeds
the ``stream.drift_psi`` gauge).

Named fault sites bracket every WAL boundary — ``stream.after_offsets`` /
``after_read`` / ``after_foreach`` / ``after_sink`` / ``after_commit`` —
so a test can kill the run at each one and resume.

With ``views`` set, the materialized views over the sink fold each
committed batch in on the commit path (``core/sql_views.py``).  The
pipelined loop (``pipeline.py``) hands a batch's first attempt the table
its worker already parsed and firewalled (``prefetched``); replays always
re-read.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Callable

import numpy as np

from ..core.table import Table
from ..device import resolve_device
from ..obs import flight_recorder as _flight
from ..obs import trace as _trace
from ..obs.registry import global_registry
from ..utils.faults import fault_point
from ..utils.logging import get_logger
from ..utils.metrics import MetricsRegistry
from ..utils.retry import DEFAULT_REPLAY_BACKOFF, RetryPolicy
from .checkpoint import StreamCheckpoint
from .source import FileStreamSource
from .unbounded_table import DiskBudgetExceeded, UnboundedTable
from .watermark import WatermarkTracker

if TYPE_CHECKING:  # typing only
    from ..quality.firewall import DataFirewall

log = get_logger("streaming")

BATCH_OK = "ok"
BATCH_QUARANTINED = "quarantined"


@dataclass
class BatchInfo:
    batch_id: int
    num_input_rows: int
    num_late_rows: int
    num_appended_rows: int
    files: list[str]
    status: str = BATCH_OK
    num_rejected_rows: int = 0     # rows the data firewall quarantined
    num_drift_events: int = 0      # schema-drift reconciliations observed


@dataclass
class StreamExecution:
    source: FileStreamSource
    sink: UnboundedTable
    checkpoint: StreamCheckpoint
    watermark: WatermarkTracker | None = None
    foreach_batch: Callable[[Table, int], None] | None = None
    #: total tries a batch gets — across replays AND process restarts —
    #: before it is quarantined instead of replayed forever
    max_batch_replays: int = 3
    replay_backoff: RetryPolicy = DEFAULT_REPLAY_BACKOFF
    metrics: MetricsRegistry = field(default_factory=MetricsRegistry)
    #: the device the table's queries and fits run on (default the card):
    #: resolved at start, so a stream meant for a missing card fails
    #: before it commits a batch, not at the first query
    device: Any = None
    #: materialized-view registry (``core/sql_views.py``): when set, every
    #: view over this sink folds the batch's delta in right after the
    #: commit record lands — exactly once per committed batch (the view's
    #: high-water mark skips replays; a crash mid-maintenance is healed by
    #: the next refresh from the commit log)
    views: Any = None
    #: data-quality firewall: when set, source reads salvage + validate
    #: per row and rejects land in ``<ckpt>/quarantine/rows/``
    firewall: "DataFirewall | None" = None
    #: append the ``ingest_time`` column (the reference script's
    #: ``withColumn("ingest_time", current_timestamp())``)
    add_ingest_time: bool = True
    history: list[BatchInfo] = field(default_factory=list)
    #: trace id of the most recent batch attempt (None when tracing off)
    last_trace_id: str | None = None
    _next_batch_id: int = 0
    _pending: dict | None = None
    #: batches whose row-quarantine metrics were already counted — a
    #: replayed attempt re-produces the same rejects, and the counters
    #: must match the (idempotent) quarantine files, not the attempt count
    _quarantine_counted: set = field(default_factory=set, repr=False)
    # entropy-seeded on purpose: replaying streams must not back off in
    # lockstep; jitter affects timing only, never data
    _rng: random.Random = field(default_factory=random.Random, repr=False)

    def __post_init__(self) -> None:
        if self.max_batch_replays < 1:
            raise ValueError(
                f"max_batch_replays must be >= 1, got {self.max_batch_replays}"
            )
        self.device = resolve_device(self.device)
        if self.firewall is not None and self.source.firewall is None:
            self.source.firewall = self.firewall
        state = self.checkpoint.recover()
        self._next_batch_id = state["next_batch_id"]
        self.source.restore(state["processed_files"])
        if self.source.metrics is None:
            self.source.metrics = self.metrics
        if self.watermark is not None and state["watermark_state"]:
            self.watermark.restore(state["watermark_state"])
        self._pending = state["pending"]
        self._register_obs()
        if self._pending:
            log.info(
                "recovering uncommitted batch",
                batch_id=self._pending["batch_id"],
                files=len(self._pending["files"]),
            )

    def _register_obs(self) -> None:
        """Fold this stream's ``stream.*`` counters into the process
        registry as a weakref pull-collector: exporters see every live
        stream's totals summed, and a dead stream silently unregisters.
        Skipped when the stream already writes the global registry."""
        g = global_registry()
        if self.metrics is g:
            return
        g.register_collector(
            f"stream:{id(self):x}", self,
            lambda s: {
                "counters": dict(s.metrics.counters),
                "gauges": dict(s.metrics.gauges),
            },
        )

    # ------------------------------------------------------------ core
    def run_once(self) -> BatchInfo | None:
        """Process at most one micro-batch; None if no new data.

        A failing batch is retried with backoff up to ``max_batch_replays``
        total attempts (the durable attempt count includes crashed
        incarnations), then quarantined.  An :class:`InjectedCrash` — like
        a real crash — propagates; the attempt it interrupted still counts
        on resume."""
        if self._pending is not None:
            entry = self._pending
            batch_id = entry["batch_id"]
            files = entry["files"]
            wm_state = entry.get("watermark") or {}
            if self.checkpoint.attempts(batch_id) >= self.max_batch_replays:
                # every replay of this batch KILLED the process: quarantine
                # without giving it another shot at the process's life
                info = self._quarantine(
                    batch_id, files, self.checkpoint.attempts(batch_id),
                    RuntimeError("batch crashed the process on every replay"),
                )
                return self._finish_batch(batch_id, info)
            info = self._run_batch(batch_id, files, wm_state)
            return self._finish_batch(batch_id, info)

        files = self.source.poll()
        if not files:
            return None
        batch_id = self._next_batch_id
        if self.checkpoint.attempts(batch_id) >= self.max_batch_replays:
            return self._finish_batch(
                batch_id, self._quarantine_fresh(batch_id, files)
            )
        wm_state = self.watermark.state() if self.watermark else {}
        # intent + first attempt land as ONE fsync'd append
        self.checkpoint.begin_batch(batch_id, files, wm_state)
        info = self._run_batch(
            batch_id, files, wm_state, first_attempt_recorded=True
        )
        return self._finish_batch(batch_id, info)

    def _quarantine_fresh(self, batch_id: int, files: list[str]) -> BatchInfo:
        """Budget already spent on the FRESH path (an in-session crash
        loop re-polls the same uncommitted files under the same batch id)
        — quarantine.  The offsets intent is written FIRST, so that the
        WAL, the evidence and restart recovery agree on the files."""
        wm_state = self.watermark.state() if self.watermark else {}
        self.checkpoint.write_offsets(batch_id, files, wm_state)
        return self._quarantine(
            batch_id, files, self.checkpoint.attempts(batch_id),
            RuntimeError("batch crashed the process on every replay"),
        )

    def _finish_batch(self, batch_id: int, info: BatchInfo) -> BatchInfo:
        self._pending = None
        self._next_batch_id = batch_id + 1
        self.history.append(info)
        return info

    def _run_batch(
        self,
        batch_id: int,
        files: list[str],
        wm_state: dict,
        first_attempt_recorded: bool = False,
        prefetched=None,
    ) -> BatchInfo:
        """The replay/quarantine ladder around :meth:`_attempt`.

        ``prefetched`` (a pipeline hand-off with the batch already parsed
        and firewalled) is consumed by the FIRST attempt only — replays
        always re-read from the source, so a corrupted prefetch can never
        wedge the ladder."""
        while True:
            if first_attempt_recorded:
                attempts = self.checkpoint.attempts(batch_id)
                first_attempt_recorded = False
            else:
                attempts = self.checkpoint.record_attempt(batch_id)
            try:
                return self._attempt(batch_id, files, wm_state, prefetched)
            except Exception as e:  # noqa: BLE001 — InjectedCrash is a
                # BaseException and rightly flies past this handler
                self.metrics.inc("stream.batch_failures")
                if isinstance(e, DiskBudgetExceeded):
                    # the disk budget is spent, not the batch poisoned:
                    # the backoff below IS the backpressure
                    self.metrics.inc("stream.backpressure")
                log.warning(
                    "batch attempt failed",
                    batch_id=batch_id, attempt=attempts,
                    max_attempts=self.max_batch_replays, error=repr(e),
                )
                prefetched = None
                if attempts >= self.max_batch_replays:
                    return self._quarantine(batch_id, files, attempts, e)
                time.sleep(self.replay_backoff.delay_for(attempts, self._rng))

    def _attempt(self, batch_id: int, files: list[str], wm_state: dict,
                 prefetched=None) -> BatchInfo:
        """One ``stream.batch`` span per attempt: the trace root a
        streaming unit of work hangs its children off."""
        sp = _trace.span("stream.batch")
        with sp:
            self.last_trace_id = sp.trace_id
            if sp.trace_id is not None:
                sp.note("batch_id", batch_id)
                sp.note("files", len(files))
                sp.note("prefetched", prefetched is not None)
            info = self._attempt_inner(batch_id, files, wm_state, prefetched)
            if sp.trace_id is not None:
                sp.note("rows", info.num_appended_rows)
            return info

    def _attempt_inner(self, batch_id: int, files: list[str], wm_state: dict,
                       prefetched=None) -> BatchInfo:
        """One try at the batch lifecycle, fault sites at every boundary.

        With ``prefetched``, the parse + firewall work already happened on
        the pipeline's worker thread (a worker's error is re-raised here,
        after the intent was written); the fault sites still fire in the
        serial order, so each kill point keeps its meaning."""
        fault_point("stream.after_offsets", batch_id=batch_id)
        # replay with the watermark state recorded at intent time (a replay
        # must see the state the original attempt saw)
        if self.watermark is not None and wm_state:
            self.watermark.restore(wm_state)
        if prefetched is not None:
            if prefetched.error is not None:
                raise prefetched.error
            table = prefetched.table
            row_rejects = prefetched.rejects
            drift_events = prefetched.drift_events
        elif self.firewall is not None:
            table, row_rejects, drift_events = self.source.read_files_audited(files)
        else:
            table = self.source.read_files(files)
            row_rejects, drift_events = [], []
        fault_point("stream.after_read", batch_id=batch_id)
        n_in = len(table) + len(row_rejects)
        if self.add_ingest_time:
            # parity with withColumn("ingest_time", current_timestamp()) :82
            now = np.datetime64(int(time.time_ns()), "ns")
            table = table.with_column(
                "ingest_time", np.full(len(table), now, dtype="datetime64[ns]")
            )
        dropped = 0
        if self.watermark is not None:
            table, dropped = self.watermark.filter_late(table)
        if row_rejects or drift_events:
            # row quarantine: idempotent on replay (same batch id, same
            # file), written before the sink so the evidence survives a
            # failing foreach / sink attempt too; the counters gate on the
            # batch id so a replayed attempt does not count the rows twice
            self.checkpoint.quarantine_rows(batch_id, row_rejects, drift_events)
            if batch_id not in self._quarantine_counted:
                self._quarantine_counted.add(batch_id)
                if row_rejects:
                    self.metrics.inc("stream.rows_rejected", len(row_rejects))
                if drift_events:
                    self.metrics.inc("stream.drift_events", len(drift_events))
            log.warning(
                "rows quarantined",
                batch_id=batch_id, rejected=len(row_rejects),
                drift_events=len(drift_events),
            )
        if prefetched is not None and prefetched.drift_psi is not None:
            # the worker read PSI right after THIS batch's parse: the live
            # monitor may already hold a later prefetch's windows
            self.metrics.set("stream.drift_psi", prefetched.drift_psi)
        elif self.firewall is not None and self.firewall.monitor is not None:
            self.metrics.set("stream.drift_psi", self.firewall.monitor.max_psi)

        if self.foreach_batch is not None:
            self._call_foreach(table, batch_id, prefetched)
        fault_point("stream.after_foreach", batch_id=batch_id)

        self.sink.append_batch(table, batch_id)
        fault_point("stream.after_sink", batch_id=batch_id)
        self.checkpoint.write_commit(batch_id)
        fault_point("stream.after_commit", batch_id=batch_id)
        if self.views is not None:
            # view maintenance rides the commit: the batch is durable, so
            # a crash inside (the sql.view.maintain fault site) replays
            # nothing — the next refresh folds the committed delta in
            # exactly once.  A non-crash failure must not fail the
            # attempt either (the batch already committed; replaying it
            # would re-run foreach): views heal lazily instead.
            try:
                self.views.maintain(self.sink, batch_id)
            except Exception as e:  # noqa: BLE001 — InjectedCrash
                # (a BaseException) still propagates like a real kill
                self.metrics.inc("stream.view_maintain_errors")
                log.warning(
                    "view maintenance failed; views catch up lazily",
                    batch_id=batch_id, error=repr(e),
                )
        self.source.commit_files(files)
        self.metrics.inc("stream.batches")

        info = BatchInfo(
            batch_id=batch_id,
            num_input_rows=n_in,
            num_late_rows=dropped,
            num_appended_rows=len(table),
            files=files,
            num_rejected_rows=len(row_rejects),
            num_drift_events=len(drift_events),
        )
        log.info(
            "batch committed",
            batch_id=batch_id, rows=info.num_appended_rows, late=dropped,
            rejected=info.num_rejected_rows,
        )
        return info

    def _call_foreach(self, table: Table, batch_id: int, prefetched) -> None:
        """Hand the batch to the consumer; the pipelined stream overrides
        this to pass its worker's staged payload instead of the table."""
        self.foreach_batch(table, batch_id)

    def _quarantine(
        self, batch_id: int, files: list[str], attempts: int, err: Exception
    ) -> BatchInfo:
        """Poison batch: record the evidence, commit the batch as skipped
        (so recovery never replays it), and let the stream move on.  The
        record says whether the batch's rows already reached the sink
        (``sink_rows_visible``), so that reprocessing its files by hand
        does not ingest them twice."""
        sink_visible = batch_id in self.sink.committed_batches()
        reason = (
            DiskBudgetExceeded.reason
            if isinstance(err, DiskBudgetExceeded) else "poison"
        )
        qpath = self.checkpoint.quarantine(
            batch_id, files, attempts, repr(err),
            sink_rows_visible=sink_visible, reason=reason,
        )
        self.checkpoint.write_commit(batch_id, quarantined=True)
        self.source.commit_files(files)
        self.metrics.inc("stream.quarantined")
        if _trace.enabled():
            _trace.record_span(
                "stream.quarantine", 0.0,
                {"batch_id": batch_id, "attempts": attempts},
            )
        # a poison batch is a postmortem moment: dump the flight ring
        _flight.notify(
            "quarantine", "stream.quarantine",
            batch_id=batch_id, attempts=attempts, error=repr(err),
        )
        log.error(
            "batch quarantined",
            batch_id=batch_id, attempts=attempts, path=qpath, error=repr(err),
        )
        return BatchInfo(
            batch_id=batch_id,
            num_input_rows=0,
            num_late_rows=0,
            num_appended_rows=0,
            files=files,
            status=BATCH_QUARANTINED,
        )

    def run(
        self,
        max_batches: int | None = None,
        timeout_s: float | None = None,
        poll_interval_s: float = 0.2,
    ) -> list[BatchInfo]:
        """Drive the loop until max_batches processed or timeout elapses —
        the ``awaitTermination`` analogue (:117-118) with a bound; with
        neither, drain what is there once."""
        done: list[BatchInfo] = []
        start = time.monotonic()
        while True:
            info = self.run_once()
            if info is not None:
                done.append(info)
                if max_batches is not None and len(done) >= max_batches:
                    return done
                continue
            if timeout_s is not None and time.monotonic() - start >= timeout_s:
                return done
            if timeout_s is None and max_batches is None:
                return done
            time.sleep(poll_interval_s)

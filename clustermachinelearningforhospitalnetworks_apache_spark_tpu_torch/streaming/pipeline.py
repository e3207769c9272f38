"""Pipelined streaming execution: overlap host ingest with device update
(the JAX package's ``streaming/pipeline.py``).

The serial :class:`~.microbatch.StreamExecution` spends each batch's wall
time in a strict chain — list files → parse CSV → firewall row-validation
→ table build → WAL → transfer → model update — with the card idle
through every host stage and the host idle while it waits on the card.
This module runs the same lifecycle as a TWO-STAGE PIPELINE:

* a single **prefetch worker** thread discovers new files and runs the
  side-effect-free host stages for batch *N+1* — native/salvage CSV scan,
  firewall validation (header reconciliation amortized through the
  firewall's mapping cache), and optionally a caller-supplied ``stage``
  hook (feature extraction + host→device transfer, giving double-buffered
  transfers: batch N+1's buffer fills while batch N's is consumed);
* the **commit thread** (whoever calls :meth:`run_once`) keeps the entire
  durability protocol in the serial order — offsets+attempt intent (one
  fsync'd append via ``StreamCheckpoint.begin_batch``), row quarantine,
  foreach (the model update launches asynchronously on the card — K1
  for StreamingKMeans — and nothing blocks until the NEXT batch needs
  the result), sink append, commit.

Backpressure is the bounded hand-off queue (``pipeline_depth``): the
worker blocks once it is that many batches ahead, so memory stays
bounded no matter how fast files arrive.

Crash semantics are IDENTICAL to the serial stream, by construction:

* nothing the worker does has durable side effects — a crash before the
  commit thread writes the batch's offsets intent simply re-discovers
  the files on restart;
* every fault site (``stream.after_offsets`` … ``after_commit``) fires
  on the commit thread in the serial order, so each chaos kill-point
  keeps its exact serial meaning;
* a worker-side failure (including an :class:`InjectedCrash` emulating
  process death mid-parse) is delivered to the commit thread and
  re-raised INSIDE the batch's attempt — after intent is recorded —
  which is byte-for-byte the serial "crash between offsets and read"
  story: the durable attempt count still advances and a restart replays
  (or, past the budget, quarantines) the batch;
* replays never trust a prefetch: the attempt ladder re-reads from the
  source serially.

Parity gate: with the same input files, the pipelined stream produces
the same batches, the same sink rows, the same quarantine evidence, and
the same WAL entries as the serial stream, and the same model state
(``tests/test_torch_stream_pipeline.py`` asserts them, plus
kill-and-resume idempotence).
"""

from __future__ import annotations

import contextvars
import threading
import time
from dataclasses import dataclass, field
from queue import Empty, Full, Queue
from typing import Any, Callable

from ..core.table import Table
from ..data import batch_rows
from ..device import resolve_device
from ..tune import knob
from ..utils.logging import get_logger
from ..utils.profiling import StageClock
from .microbatch import BatchInfo, StreamExecution

log = get_logger("streaming")


@dataclass
class Prefetched:
    """One batch's host work, done ahead of time by the worker."""

    files: list[str]
    table: Table | None = None
    rejects: list = field(default_factory=list)
    drift_events: list = field(default_factory=list)
    #: drift monitor PSI snapshotted right after THIS batch's parse (the
    #: live monitor may already reflect later prefetches)
    drift_psi: float | None = None
    #: output of the caller's ``stage`` hook (features extracted and/or
    #: already transferred to device) — handed to ``foreach_batch``
    staged: Any = None
    #: a worker-side failure, re-raised inside the batch's first attempt
    error: BaseException | None = None


class _Prefetcher(threading.Thread):
    """The single worker: polls, parses, firewalls, stages — in claim
    order, one batch at a time, so the firewall's stateful pieces (drift
    windows, reconciliation cache) see files in exactly the serial order."""

    def __init__(
        self, exec_: "PipelinedStreamExecution", depth: int, poll_interval_s: float
    ) -> None:
        super().__init__(daemon=True, name="stream-prefetch")
        self._exec = exec_
        self.queue: Queue = Queue(maxsize=max(1, depth))
        #: files handed into the pipeline but not yet committed (the
        #: source's ``_seen`` only advances at commit time)
        self.claimed: set[str] = set()
        self._seen_cache: tuple[frozenset, int] = (frozenset(), -1)
        self.poll_interval_s = poll_interval_s
        self._halt = threading.Event()  # NOT _stop: Thread.join() calls an internal _stop()
        self._wake = threading.Event()
        self._cond = threading.Condition()
        #: listing-cycle sequence: bumped when a directory listing STARTS,
        #: with the seq of the last listing that came up empty — poll_now
        #: must wait for an empty listing that BEGAN after the call (one
        #: already in flight may predate a just-dropped file)
        self._poll_seq = 0
        self._last_empty_seq = -1
        self._inflight = False
        #: serializes INGEST (discovery + parse + firewall): replays
        #: re-read through the SAME source/firewall objects on the commit
        #: thread, and their counters/drift windows/mapping cache are
        #: plain mutable state — the worker holds this for each
        #: discover+parse cycle (never across the queue hand-off), the
        #: replay path holds it for the serial re-read
        self.ingest_lock = threading.Lock()
        #: observability context snapshot: a fresh thread gets
        #: an EMPTY contextvars context, which would orphan the worker's
        #: ``stage.*`` spans from the trace the stream runs under — the
        #: loop executes inside a copy of the creator's context instead,
        #: so prefetch-side spans carry the ambient trace id
        self._obs_ctx = contextvars.copy_context()

    # ------------------------------------------------------------ control
    def stop(self) -> None:
        self._halt.set()
        self._wake.set()

    def busy(self) -> bool:
        with self._cond:
            # a dead worker (loop-level failure or interpreter teardown)
            # can never produce again — reporting it busy would make the
            # consumer's wait loops spin forever
            return (self._inflight and self.is_alive()) or not self.queue.empty()

    def poll_now(self, timeout_s: float = 10.0) -> None:
        """Force an immediate poll and wait until either data is queued
        or a listing that STARTED after this call came up empty — so the
        caller's "no new data" answer is as authoritative as a serial
        ``source.poll()`` (an in-flight listing may predate a file the
        caller just dropped, and must not count)."""
        with self._cond:
            seq0 = self._poll_seq
            self._wake.set()
            deadline = time.monotonic() + timeout_s
            while (
                self._last_empty_seq <= seq0
                and self.queue.empty()
                and not self._halt.is_set()
                and time.monotonic() < deadline
            ):
                self._cond.wait(0.02)

    # ------------------------------------------------------------ worker
    def _new_files(self) -> list[str]:
        src = self._exec.source
        # copying the (ever-growing) committed-file set every 50 ms idle
        # poll would be O(total files) per cycle forever — the generation
        # counter makes the copy happen only when a commit changed it
        gen = src.seen_generation()
        if self._seen_cache[1] != gen:
            self._seen_cache = (src.seen_snapshot(), gen)
        seen = self._seen_cache[0]
        # committed files live in the source's seen-set — drop them from
        # the claim index so it tracks only the (bounded) in-pipeline
        # window instead of growing for the life of a 24/7 stream
        self.claimed.difference_update(seen)
        new = [
            f
            for f in src.list_files()
            if f not in seen and f not in self.claimed
        ]
        cap = src.files_cap()
        if cap > 0:
            new = new[:cap]
        return new

    def run(self) -> None:
        self._obs_ctx.run(self._loop)

    def _loop(self) -> None:  # pragma: no branch - loop structure
        while not self._halt.is_set():
            # bounded acquire so stop() is never ignored: a replay on the
            # commit thread may hold the ingest lock for a while
            if not self.ingest_lock.acquire(timeout=0.1):
                continue
            pre = None
            try:
                with self._cond:
                    self._inflight = True
                    self._poll_seq += 1
                    seq = self._poll_seq
                files = self._new_files()
                if files:
                    self.claimed.update(files)
                    pre = self._produce(files)
            except BaseException as e:  # noqa: BLE001 — discovery failed
                # (e.g. a file deleted between listing and stat).  The
                # serial stream would surface this from poll(); deliver
                # it so run_once re-raises instead of hanging on a dead
                # worker (files unknown → no batch intent is written).
                pre = Prefetched(files=[], error=e)
            finally:
                self.ingest_lock.release()
            if pre is None:  # empty poll
                with self._cond:
                    self._inflight = False
                    self._last_empty_seq = seq
                    self._cond.notify_all()
                self._wake.wait(self.poll_interval_s)
                self._wake.clear()
                continue
            while not self._halt.is_set():
                try:
                    self.queue.put(pre, timeout=0.1)
                    break
                except Full:  # bounded queue: backpressure on the worker
                    continue
            with self._cond:
                self._inflight = False
                self._cond.notify_all()

    def _produce(self, files: list[str]) -> Prefetched:
        ex = self._exec
        try:
            with ex.clock.stage("ingest"):
                if ex.firewall is not None:
                    table, rejects, events = ex.source.read_files_audited(files)
                else:
                    table = ex.source.read_files(files)
                    rejects, events = [], []
            psi = (
                ex.firewall.monitor.max_psi
                if ex.firewall is not None and ex.firewall.monitor is not None
                else None
            )
            staged = None
            if ex.stage is not None:
                with ex.clock.stage("stage"):
                    staged = ex.stage(table)
            return Prefetched(
                files=files,
                table=table,
                rejects=rejects,
                drift_events=events,
                drift_psi=psi,
                staged=staged,
            )
        except BaseException as e:  # noqa: BLE001 — InjectedCrash included:
            # the commit thread re-raises it inside the batch's attempt,
            # where the serial stream would have hit it
            log.warning(
                "prefetch failed; delivering error to the commit thread",
                files=len(files), error=repr(e),
            )
            return Prefetched(files=files, error=e)


@dataclass
class PipelinedStreamExecution(StreamExecution):
    """Drop-in :class:`StreamExecution` with prefetch-pipelined ingest.

    Extra knobs:

    * ``pipeline_depth`` — bounded prefetch queue (backpressure bound);
    * ``worker_poll_interval_s`` — idle re-list cadence of the worker;
    * ``stage`` — optional host-side hook run on the WORKER thread per
      batch (feature extraction, a host→device copy).  When set,
      ``foreach_batch`` receives the staged value instead of the raw
      Table (the raw table still goes to the sink).  The hook's input is
      the batch's ACCEPTED SOURCE rows — no stream-added ``ingest_time``
      column (re-stages drop it for parity with the worker's view).  When the consumer
      coalesces backlogs through ``update_many``, stage should return
      host arrays, which the consumer moves to its device;
    * ``clock`` — per-stage wall-time accumulator (``ingest`` / ``stage``
      on the worker, ``update`` on the commit thread), the observable
      evidence of the overlap: summed stage seconds exceeding wall time
      is host work hidden behind the update.

    Call :meth:`close` (or use as a context manager) when done.
    """

    #: None → knob registry (stream.pipeline.depth /
    #: stream.worker.poll_interval_ms), resolved when the worker spawns
    pipeline_depth: int | None = None
    worker_poll_interval_s: float | None = None
    stage: Callable[[Table], Any] | None = None
    clock: StageClock = field(default_factory=StageClock)
    _prefetcher: _Prefetcher | None = field(default=None, repr=False)

    # ------------------------------------------------------------ lifecycle
    def _ensure_prefetcher(self) -> _Prefetcher:
        # only reached with no pending batch (run_once routes pending
        # recovery through the serial path first, and its commit marks
        # the files seen before the worker could ever re-claim them)
        if self._prefetcher is None:
            depth = (
                int(knob("stream.pipeline.depth"))
                if self.pipeline_depth is None else self.pipeline_depth
            )
            poll = (
                knob("stream.worker.poll_interval_ms") / 1e3
                if self.worker_poll_interval_s is None
                else self.worker_poll_interval_s
            )
            self._prefetcher = _Prefetcher(self, depth, poll)
            self._prefetcher.start()
        return self._prefetcher

    def close(self) -> None:
        if self._prefetcher is not None:
            self._prefetcher.stop()
            self._prefetcher.join(timeout=5.0)
            # forget the halted worker: a later run_once() spawns a fresh
            # one, so a transient error (surfaced and raised once, like a
            # serial poll() failure) doesn't leave the stream permanently
            # answering "no new data" through a dead prefetcher
            self._prefetcher = None

    def __enter__(self) -> "PipelinedStreamExecution":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def ready_depth(self) -> int:
        """Prefetched batches already waiting — consumers use this to
        drain bursts through ``update_many`` instead of per-batch calls."""
        return (
            self._prefetcher.queue.qsize() if self._prefetcher is not None else 0
        )

    # ------------------------------------------------------------ core
    def run_once(self) -> BatchInfo | None:
        if self._pending is not None:
            # crash recovery: replay the uncommitted batch through the
            # serial path (a replay must re-read, never trust a prefetch)
            return super().run_once()
        pf = self._ensure_prefetcher()
        try:
            pre = pf.queue.get_nowait()
        except Empty:
            pf.poll_now()
            while True:  # mid-parse on a large batch: wait it out
                try:
                    pre = pf.queue.get(timeout=0.05)
                    break
                except Empty:
                    if not pf.busy():
                        return None

        if not pre.files:
            # file DISCOVERY failed on the worker (no batch exists yet,
            # so no intent to record) — surface it like a serial poll()
            # failure and stop the pipeline
            self.close()
            raise pre.error

        batch_id = self._next_batch_id
        if self.checkpoint.attempts(batch_id) >= self.max_batch_replays:
            # the serial stream's fresh-path budget guard, shared
            return self._finish_batch(
                batch_id, self._quarantine_fresh(batch_id, pre.files)
            )
        wm_state = self.watermark.state() if self.watermark else {}
        try:
            # intent + first attempt: ONE fsync'd append, exactly the
            # serial protocol — from here on the lifecycle is the
            # parent's.  Inside the try: if even the intent write fails,
            # the worker must still be stopped (close() also frees the
            # batch's files from the claimed set, so a restarted or
            # retried stream re-discovers them instead of skipping them
            # for the rest of this stream's life).
            self.checkpoint.begin_batch(batch_id, pre.files, wm_state)
            info = self._run_batch(
                batch_id, pre.files, wm_state,
                prefetched=pre, first_attempt_recorded=True,
            )
        except BaseException:
            # a crash (injected or real) ends this stream's life: stop the
            # worker so tests and operators never leak a polling thread
            self.close()
            raise
        return self._finish_batch(batch_id, info)

    def _attempt(
        self, batch_id: int, files: list[str], wm_state: dict, prefetched=None
    ):
        if prefetched is not None:
            return super()._attempt(batch_id, files, wm_state, prefetched)
        # serial re-read (replay or pending recovery): it goes through the
        # SAME source/firewall objects the worker uses, whose counters and
        # drift windows are plain mutable state — take the ingest lock so
        # the worker's discover+parse cycle can never interleave with it
        pf = self._prefetcher
        if pf is None or not pf.is_alive():
            return super()._attempt(batch_id, files, wm_state, None)
        with pf.ingest_lock:
            return super()._attempt(batch_id, files, wm_state, None)

    def _call_foreach(self, table: Table, batch_id: int, prefetched) -> None:
        payload = table
        if self.stage is not None:
            # the worker staged the PRE-watermark table; its payload is
            # only valid when filtering dropped nothing (row counts
            # equal).  Late rows must never train the model when the
            # serial stream would have dropped them — re-stage otherwise
            # (replays always re-stage too).
            if (
                prefetched is not None
                and prefetched.staged is not None
                and prefetched.table is not None
                and len(table) == len(prefetched.table)
            ):
                payload = prefetched.staged
            else:
                # the hook's contract is the ACCEPTED SOURCE rows — drop
                # the stream-added ingest_time column so a re-stage sees
                # the same column set the worker staged from
                view = (
                    table.drop("ingest_time")
                    if self.add_ingest_time and "ingest_time" in table.schema
                    else table
                )
                payload = self.stage(view)
        with self.clock.stage("update"):
            self.foreach_batch(payload, batch_id)


@dataclass
class ModelUpdateConsumer:
    """``foreach_batch`` consumer feeding a streaming estimator, with
    backlog coalescing.

    Steady state (nothing else prefetched): one ``model.update(batch)``
    per batch on ``device`` (default the card; the update launches
    asynchronously).  When the pipeline reports a backlog
    (``ready_depth() > 0``), batches are buffered and the burst is
    flushed through ``model.update_many`` in power-of-two drains — the
    same decayed updates as the per-batch calls, in the same order.
    ``mesh`` (the reference's) hands each update and drain the mesh
    instead of ``device``: the estimator's adaptive placement decides
    whether a batch is sharded.

    Note on semantics: a buffered update may execute after its batch's
    commit.  The model state is in-memory either way (a crash loses it
    regardless of ordering, and replay-after-crash re-delivers every
    uncommitted batch), so durability invariants are unchanged; call
    :meth:`flush` before reading ``latest_model`` mid-stream.
    """

    model: Any
    pipeline: PipelinedStreamExecution | None = None
    mesh: Any = None
    max_backlog: int = 16
    updates: int = 0
    batches_drained: int = 0
    _buf: list = field(default_factory=list)
    _seen_rows: bool = False
    #: where the updates run without a mesh (default the card)
    device: Any = None

    def __post_init__(self) -> None:
        if self.mesh is not None and self.device is not None:
            raise ValueError("pass a mesh or a device, not both")
        if self.mesh is None:
            self.device = resolve_device(self.device)

    def _where(self) -> dict:
        """The placement each update and drain is handed."""
        return {"mesh": self.mesh} if self.mesh is not None else {"device": self.device}

    def __call__(self, batch, batch_id: int) -> None:
        if batch_rows(batch) == 0:
            # an EMPTY batch still decays an initialized model (Spark's
            # per-batch alpha in "batches" time units — a serial
            # unconditional foreach would apply it too, and parity with
            # that is the contract); before any rows have arrived there
            # is no state to decay and nothing to initialize from
            if not self._seen_rows:
                return
        else:
            self._seen_rows = True
        self._buf.append(batch)
        backlog = (
            self.pipeline.ready_depth() if self.pipeline is not None else 0
        )
        if (
            backlog > 0
            and len(self._buf) < self.max_backlog
            and hasattr(self.model, "update_many")
        ):
            return  # more is coming: coalesce into one drain
        try:
            self.flush()
        except BaseException:
            # this exception fails the CURRENT batch's attempt, and its
            # replay re-delivers the batch — drop it from the restored
            # buffer so the retry doesn't apply it twice.  Earlier
            # (already-committed) deferred batches stay buffered: their
            # attempts succeeded, only the next flush can apply them.
            for i, b in enumerate(self._buf):
                if b is batch:
                    del self._buf[i]
                    break
            raise

    def flush(self) -> None:
        buf, self._buf = self._buf, []
        if not buf:
            return
        applied = 0
        try:
            if len(buf) == 1 or not hasattr(self.model, "update_many"):
                for b in buf:
                    self.model.update(b, **self._where())
                    self.updates += 1
                    applied += 1
                return
            # drain in power-of-two chunks (8+2 → 8, 2), the reference's
            # decomposition (its scanned drain compiles once a length):
            # the same per-batch update sequence
            i, n = 0, len(buf)
            while n - i >= 2:
                size = 1 << ((n - i).bit_length() - 1)
                self.model.update_many(buf[i : i + size], **self._where())
                self.batches_drained += size
                i += size
                applied = i
            for b in buf[i:]:
                self.model.update(b, **self._where())
                self.updates += 1
                applied += 1
        except BaseException:
            # keep every unapplied batch — deferred updates of batches
            # that already committed must never be lost to a transient
            # update failure (they'd silently diverge from serial)
            self._buf = buf[applied:] + self._buf
            raise


def make_sql_feature_stage(
    statement: str,
    feature_cols,
    label_col: str | None = None,
    min_compiled_rows: int | None = None,
    device=None,
):
    """Stage-hook factory: run a SQL statement over each micro-batch's
    accepted rows on the prefetch worker, then extract the float32
    feature matrix (and label) for the update consumer.

    The statement references the batch as ``__THIS__`` (the
    SQLTransformer convention) and goes through ``core.sql.execute``'s
    dispatcher, so supported plans — numeric filters, derived-feature
    arithmetic, the LOS window shapes — run on the compiled executor on
    ``device`` (default the card).  Batches under ``min_compiled_rows``
    force the interpreter: a micro-batch's table is fresh (cold
    device-column cache), and for small batches the transfer costs more
    than host numpy.

    Returns HOST arrays (``x`` or ``(x, y)``): staged payloads must be
    re-stageable bit-identically on the commit thread for watermark /
    replay parity, so the copy to the card stays with the consumer.
    """
    from ..core.sql import execute

    dev = resolve_device(device)
    feature_cols = list(feature_cols)
    stmt = statement.replace("__THIS__", "__this__")
    if min_compiled_rows is None:
        # resolved once per stage build, not per batch: Flare's decide-
        # ahead rule — the threshold must not flap mid-stream
        min_compiled_rows = int(knob("sql.stage.min_compiled_rows"))

    def _resolver(table: Table):
        # per-call closure (the worker and a commit-thread re-stage may
        # run concurrently); only the batch itself is visible — a wrong
        # FROM (a session table name, a typo) must fail loudly, not
        # silently run against the micro-batch
        def resolve(name: str) -> Table:
            if name == "__this__":
                return table
            raise KeyError(
                f"unknown table {name!r}; a streaming SQL stage sees "
                "only __THIS__ (the micro-batch)"
            )

        return resolve

    def stage(table: Table):
        import numpy as np

        mode = "auto" if len(table) >= min_compiled_rows else "interpret"
        out = execute(stmt, _resolver(table), mode=mode, device=dev)
        x = out.numeric_matrix(feature_cols).astype(np.float32)
        if label_col is None:
            return x
        return x, out.column(label_col).astype(np.float32)

    return stage

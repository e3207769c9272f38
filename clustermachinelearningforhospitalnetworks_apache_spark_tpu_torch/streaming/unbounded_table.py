"""Unbounded append-only table with an atomic commit log (the JAX
package's ``streaming/unbounded_table.py``; the same part files, commit
lines and column types, so a table written by either package is read and
appended to by the other).

Replaces the reference's Delta-table streaming sink (``writeStream...
.format("delta").outputMode("append").table("hospital_unbounded_table")``,
``mllearnforhospitalnetwork.py:111-115``): each committed micro-batch is
one Parquet part file plus one JSON line in ``_commits.log``.  Readers
only see committed parts; appends are idempotent per batch id (part files
are named by batch id and rewritten on replay, and the later commit line
wins); the log is fsync-appended with torn-tail repair (``wal.py``), so a
crash at any byte boundary loses at most the in-flight batch's commit
line.

The commit log may also hold the history lifecycle's entries.  ``retire``
and ``scrub`` are audit records that change no content, and readers skip
them.  A ``seal`` entry moves batches into a sealed segment
(``core/segments.py`` in the JAX package), which the port reads only from
slice 6 on: until then ``read()`` raises :class:`SealedSegmentsNotPorted`
rather than give an answer without the sealed rows.  For the same
reason a committed part that is missing raises ``FileNotFoundError``
(the JAX package skips it: its retired parts are served from their
segment).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from ..core.schema import Schema
from ..core.table import Table
from ..io.model_io import fsync_dir
from ..obs.registry import global_registry
from ..utils.faults import fault_point
from .wal import append_line, read_lines

COMMIT_LOG = "_commits.log"


def _pyarrow():
    """The ``pyarrow`` module, imported at first use: the parts are
    Parquet, and pyarrow is the project's ``parquet`` extra."""
    try:
        import pyarrow as pa
    except ImportError as e:
        raise ImportError(
            "the unbounded table's Parquet parts need pyarrow: install the "
            "project's 'parquet' extra (pip install '.[parquet]')"
        ) from e
    return pa


class DiskBudgetExceeded(RuntimeError):
    """The table's configured disk budget is spent: ingest must stop
    (backpressure upstream, quarantine with reason ``disk:budget`` when
    retries exhaust) while reads keep serving committed state."""

    reason = "disk:budget"


class SealedSegmentsNotPorted(NotImplementedError):
    """The commit log seals batches into segments, which the port reads
    from slice 6 on (``core/segments.py``)."""


@dataclass
class UnboundedTable:
    path: str
    schema: Schema
    name: str = "hospital_unbounded_table"
    #: soft cap on total on-disk bytes under ``path``; ``append_batch``
    #: refuses (typed ``DiskBudgetExceeded``) once spent
    disk_budget_bytes: int | None = None
    # snapshot memo: assembly key → Table, and upto_batch_id → (commit-log
    # stat, assembly key) for the stat fast path (see read())
    _snapshots: dict = field(default_factory=dict, repr=False, compare=False)
    _memo_keys: dict = field(default_factory=dict, repr=False, compare=False)

    def __post_init__(self) -> None:
        os.makedirs(self.path, exist_ok=True)

    # ------------------------------------------------------------- write
    def _part_path(self, batch_id: int) -> str:
        return os.path.join(self.path, f"part-{batch_id:010d}.parquet")

    def on_disk_bytes(self) -> int:
        """Total bytes under the table directory."""
        total = 0
        for root, _dirs, files in os.walk(self.path):
            for fn in files:
                try:
                    total += os.stat(os.path.join(root, fn)).st_size
                except OSError:
                    continue
        return total

    def append_batch(self, table: Table, batch_id: int) -> dict:
        """Write a batch's rows as its part file and commit it.

        Idempotent per batch_id: a replayed batch overwrites the same part
        file and the duplicate commit line is de-duplicated on read.
        """
        if self.disk_budget_bytes is not None:
            used = self.on_disk_bytes()
            if used >= self.disk_budget_bytes:
                raise DiskBudgetExceeded(
                    f"disk:budget — table {self.name!r} holds {used} bytes"
                    f" >= budget {self.disk_budget_bytes}; refusing new"
                    " appends (committed state keeps serving)"
                )
        part = self._part_path(batch_id)
        self._write_parquet(table, part)
        entry = {"batch_id": batch_id, "file": os.path.basename(part), "rows": len(table)}
        append_line(os.path.join(self.path, COMMIT_LOG), entry)
        return entry

    def _write_parquet(self, table: Table, path: str) -> None:
        _pyarrow()                   # first: a missing pyarrow names its extra
        import pyarrow.parquet as pq

        arrow = table.to_arrow()

        fault_point("sink.write_part", path=path)
        tmp = path + ".tmp"
        pq.write_table(arrow, tmp)
        # fsync the bytes, then the rename, then the directory: the
        # commit-log append is fsync'd, so without these a power loss
        # could keep the commit line and drop the part it declares
        with open(tmp, "rb+") as f:
            os.fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(self.path)

    # -------------------------------------------------------------- read
    def _part_stat(self, fname: str) -> tuple[int, int]:
        """(size, mtime_ns) of a file under the table — content identity
        beyond the commit entry's (file, rows), which a same-count replay
        leaves unchanged."""
        try:
            st = os.stat(os.path.join(self.path, fname))
            return int(st.st_size), int(st.st_mtime_ns)
        except OSError:
            return (-1, -1)

    def commit_log_stat(self) -> tuple[int, int]:
        """(size, mtime_ns) of the commit log — a cheap change detector.
        Every append AND every replay appends a commit line, so an
        unchanged stat means the committed state is unchanged."""
        return self._part_stat(COMMIT_LOG)

    def _log_entries(self) -> list[dict]:
        return read_lines(os.path.join(self.path, COMMIT_LOG))

    def committed_batches(self) -> dict[int, dict]:
        """Batch entries by id, the later replay winning; lifecycle
        entries (seal, retire, scrub) are not batches."""
        return {int(e["batch_id"]): e for e in self._log_entries() if "batch_id" in e}

    def _assembly(self, upto_batch_id: int | None) -> list[tuple[int, dict]]:
        """The snapshot's parts in batch-id order, from one log replay."""
        batches: dict[int, dict] = {}
        for e in self._log_entries():
            if "seal" in e:
                raise SealedSegmentsNotPorted(
                    f"table {self.name!r} has sealed segments (a 'seal' entry "
                    f"in {COMMIT_LOG}); reading them comes with slice 6 of the port"
                )
            if "batch_id" in e:
                batches[int(e["batch_id"])] = e
        return [
            (bid, batches[bid]) for bid in sorted(batches)
            if upto_batch_id is None or bid <= upto_batch_id
        ]

    def _materialize(self, items: list[tuple[int, dict]]) -> Table:
        paths = []
        for bid, e in items:
            if e["rows"] == 0:
                continue
            p = os.path.join(self.path, e["file"])
            if not os.path.exists(p):
                raise FileNotFoundError(
                    f"batch {bid} of table {self.name!r} is committed but its "
                    f"part {e['file']} is missing"
                )
            paths.append(p)
        if not paths:
            return Table.empty(self.schema)
        pa = _pyarrow()
        import pyarrow.parquet as pq

        # schema inferred from the data: committed batches carry derived
        # columns (ingest_time, :82) beyond the declared source schema
        return Table.from_arrow(pa.concat_tables([pq.read_table(p) for p in paths]))

    def read(self, upto_batch_id: int | None = None) -> Table:
        """Snapshot of all committed rows (what the reference's
        ``spark.sql`` over the output table reads, ``:123-128``);
        ``upto_batch_id`` pins it to the batches with id ≤ it.

        Memoized per commit-log state: between appends, every ``read()``
        returns the SAME ``Table`` object, so its device-column cache
        (``Table.device_column``) survives across queries and a rerun of
        the window query transfers nothing.  An append, or a replay that
        changes any commit entry or part, changes the key and drops the
        snapshot.  Hits and misses count on the process registry as
        ``sql.cache.snapshot.{hit,miss}``.
        """
        reg = global_registry()
        # commit-log stat fast path: every append and replay appends a
        # commit line, so an unchanged (size, mtime_ns) proves the
        # committed state unchanged — skip the log parse and part stats
        stat = self.commit_log_stat()
        fast = self._memo_keys.get(upto_batch_id)
        if fast is not None and fast[0] == stat and fast[1] in self._snapshots:
            reg.inc("sql.cache.snapshot.hit")
            return self._snapshots[fast[1]]
        items = self._assembly(upto_batch_id)
        # each part's (size, mtime_ns) is in the key: a replayed batch
        # with the same row count still rewrites its part file
        key = tuple((bid, e["file"], e["rows"], self._part_stat(e["file"]))
                    for bid, e in items)
        self._memo_keys[upto_batch_id] = (stat, key)
        while len(self._memo_keys) > 8:      # pins come and go; never unbounded
            self._memo_keys.pop(next(iter(self._memo_keys)))
        if key in self._snapshots:
            reg.inc("sql.cache.snapshot.hit")
            return self._snapshots[key]
        reg.inc("sql.cache.snapshot.miss")
        t = self._materialize(items)
        while len(self._snapshots) >= 4:
            self._snapshots.pop(next(iter(self._snapshots)))
        self._snapshots[key] = t
        return t

    # ------------------------------------------------------------- misc
    def num_rows(self) -> int:
        return sum(e["rows"] for e in self.committed_batches().values())

    def max_batch_id(self) -> int:
        entries = self.committed_batches()
        return max(entries) if entries else -1

"""Unbounded append-only table with an atomic commit log (the JAX
package's ``streaming/unbounded_table.py``; the same part files, sealed
segments, commit lines and column types, so a table written by either
package is read and appended to by the other).

Replaces the reference's Delta-table streaming sink (``writeStream...
.format("delta").outputMode("append").table("hospital_unbounded_table")``,
``mllearnforhospitalnetwork.py:111-115``): each committed micro-batch is
one Parquet part file plus one JSON line in ``_commits.log``.  Readers
only see committed parts; appends are idempotent per batch id (part files
are named by batch id and rewritten on replay, and the later commit line
wins); the log is fsync-appended with torn-tail repair (``wal.py``), so a
crash at any byte boundary loses at most the in-flight batch's commit
line.

History lifecycle: the commit log is the single source of truth for
three entry kinds, replayed in order with later-wins —

* ``{"batch_id", "file", "rows"}`` — a committed part;
* ``{"seal": {first, last, file, manifest, rows, batches, crc32c,
  size}}`` — a contiguous run of batches compacted into one sealed
  segment under ``_segments/`` (``core/segments.py``); a batch entry
  appended after a seal (a replay) supersedes the sealed copy of that
  one batch;
* ``{"retire": {...}}`` / ``{"scrub": {...}}`` — audit records from the
  lifecycle (``core/table_lifecycle.py``); they change no logical
  content and readers skip them.

``read()`` assembles hot parts and sealed segments into one snapshot in
batch-id order, verifying every segment's bytes against the CRC32C record
in its seal entry — bitrot is served from the surviving parts or raises
a typed :class:`~..core.segments.SegmentCorruptError`, never a silent
wrong answer.  A committed part that the read plan lists and that is
missing raises ``FileNotFoundError``: the plan never lists a part that a
segment serves, so a missing one is data loss (the JAX package skips
it).  All of this is host work and takes no ``device=``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from ..core.schema import Schema
from ..core.segments import (
    SEGMENT_DIR,
    SegmentCorruptError,
    load_manifest,
    pyarrow_module,
    read_segment,
    segment_may_match,
)
from ..core.table import Table
from ..io.model_io import fsync_dir
from ..obs.registry import global_registry
from ..utils.faults import fault_point
from .wal import append_line, read_lines

COMMIT_LOG = "_commits.log"

#: scan_pruned fast-path sentinel: "nothing pruned — serve the full
#: memoized snapshot" (distinct from None = "everything pruned")
_FULL_SNAPSHOT = object()


class DiskBudgetExceeded(RuntimeError):
    """The table's configured disk budget is spent: ingest must stop
    (backpressure upstream, quarantine with reason ``disk:budget`` when
    retries exhaust) while reads keep serving committed state."""

    reason = "disk:budget"


def _seal_offsets(seal: dict) -> dict[int, tuple[int, int]]:
    """batch_id → (row_start, row_end) inside the sealed segment, from the
    seal entry's ordered batches list."""
    offs: dict[int, tuple[int, int]] = {}
    acc = 0
    for b in seal["batches"]:
        r = int(b["rows"])
        offs[int(b["batch_id"])] = (acc, acc + r)
        acc += r
    return offs


@dataclass
class UnboundedTable:
    path: str
    schema: Schema
    name: str = "hospital_unbounded_table"
    #: soft cap on total on-disk bytes under ``path``; ``append_batch``
    #: refuses (typed ``DiskBudgetExceeded``) once spent — a retention
    #: tick that retires superseded parts is what frees space
    disk_budget_bytes: int | None = None
    # snapshot memo: assembly key → Table, and upto_batch_id → (commit-log
    # stat, assembly key) for the stat fast path (see read()); the pruned
    # scan's memos, and the manifests' zone maps by manifest stat
    _snapshots: dict = field(default_factory=dict, repr=False, compare=False)
    _memo_keys: dict = field(default_factory=dict, repr=False, compare=False)
    _pruned_fast: dict = field(default_factory=dict, repr=False, compare=False)
    _pruned_cache: dict = field(default_factory=dict, repr=False, compare=False)
    _zone_cache: dict = field(default_factory=dict, repr=False, compare=False)

    def __post_init__(self) -> None:
        os.makedirs(self.path, exist_ok=True)

    # ------------------------------------------------------------- write
    def _part_path(self, batch_id: int) -> str:
        return os.path.join(self.path, f"part-{batch_id:010d}.parquet")

    @property
    def segments_dir(self) -> str:
        return os.path.join(self.path, SEGMENT_DIR)

    def on_disk_bytes(self) -> int:
        """Total bytes under the table directory (parts, sealed segments,
        manifests, logs, quarantined rot — everything that occupies the
        disk the budget bounds)."""
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
                    " appends (committed state keeps serving; retention"
                    " frees space)"
                )
        part = self._part_path(batch_id)
        self._write_parquet(table, part)
        entry = {"batch_id": batch_id, "file": os.path.basename(part), "rows": len(table)}
        self.append_commit_entry(entry)
        return entry

    def _write_parquet(self, table: Table, path: str) -> None:
        pyarrow_module()             # first: a missing pyarrow names its extra
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

    def append_commit_entry(self, entry: dict) -> None:
        """Durably append a commit-log entry — a batch, or a lifecycle
        entry (seal/retire/scrub): the same fsync'd WAL append, so the log
        stays the single source of truth for every state transition."""
        append_line(os.path.join(self.path, COMMIT_LOG), entry)

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
        Every append, replay, seal and retire appends a commit line, so an
        unchanged stat means the committed state is unchanged."""
        return self._part_stat(COMMIT_LOG)

    def _log_entries(self) -> list[dict]:
        return read_lines(os.path.join(self.path, COMMIT_LOG))

    def committed_batches(self) -> dict[int, dict]:
        """Batch entries by id, the later replay winning; lifecycle
        entries (seal, retire, scrub) are not batches.  Each entry carries
        its log position ``_seq`` for later-wins arbitration against
        seals."""
        out: dict[int, dict] = {}
        for seq, e in enumerate(self._log_entries()):
            if "batch_id" in e:
                d = dict(e)
                d["_seq"] = seq
                out[int(e["batch_id"])] = d
        return out

    def _committed_state(self) -> tuple[dict[int, dict], list[dict]]:
        """One log replay → (batches by id, committed seals), each stamped
        with its log position ``_seq``, so the later-wins races (a batch
        replayed after its seal supersedes the sealed copy; a re-staged
        seal supersedes the one it replaces) resolve from the log order
        alone."""
        batches: dict[int, dict] = {}
        seals: dict[tuple[int, int], dict] = {}
        for seq, e in enumerate(self._log_entries()):
            if "batch_id" in e:
                d = dict(e)
                d["_seq"] = seq
                batches[int(e["batch_id"])] = d
            elif "seal" in e:
                s = dict(e["seal"])
                s["_seq"] = seq
                seals[(int(s["first"]), int(s["last"]))] = s
        return batches, list(seals.values())

    def _assembly(self, upto_batch_id: int | None = None) -> tuple[list, dict[int, dict]]:
        """The snapshot read plan, in batch-id order: ``("part", bid,
        entry)`` items and ``("seg", seal, [bids])`` runs (adjacent bids
        served by the same seal — a contiguous row slice of the segment,
        because every bid a seal covers appears in the plan, so nothing
        the seal covers can sort between run members)."""
        batches, seals = self._committed_state()
        seg_of: dict[int, dict] = {}
        for s in sorted(seals, key=lambda s: s["_seq"]):
            for b in s["batches"]:
                seg_of[int(b["batch_id"])] = s  # later seal wins
        bids = set(batches) | set(seg_of)
        if upto_batch_id is not None:
            bids = {b for b in bids if b <= upto_batch_id}
        items: list = []
        for bid in sorted(bids):
            s = seg_of.get(bid)
            e = batches.get(bid)
            if s is not None and (e is None or e["_seq"] < s["_seq"]):
                if items and items[-1][0] == "seg" and items[-1][1] is s:
                    items[-1][2].append(bid)
                else:
                    items.append(("seg", s, [bid]))
            else:
                items.append(("part", bid, e))
        return items, batches

    def _assembly_key(self, items: list) -> tuple:
        """Memo key: one (bid, file, rows, stat) tuple per batch, with
        segment-served batches keyed by the segment file's stat — a
        re-staged segment (or a retire that flips a part to its sealed
        copy) changes the key and drops the snapshot."""
        key = []
        for it in items:
            if it[0] == "part":
                e = it[2]
                key.append((it[1], e["file"], e["rows"], self._part_stat(e["file"])))
            else:
                s = it[1]
                sfile = SEGMENT_DIR + "/" + s["file"]
                sstat = self._part_stat(sfile)
                rows_by = {int(b["batch_id"]): int(b["rows"]) for b in s["batches"]}
                for bid in it[2]:
                    key.append((bid, sfile, rows_by[bid], sstat))
        return tuple(key)

    def _seal_arrow(self, seal: dict, cache: dict):
        """CRC-verified Arrow table of a sealed segment (None when the
        bytes are rotten — the caller decides whether parts survive to
        serve the run, and raises when they don't)."""
        f = seal["file"]
        if f in cache:
            return cache[f]
        try:
            at = read_segment(self.segments_dir, f,
                              {"crc32c": seal["crc32c"], "size": seal["size"]})
        except SegmentCorruptError:
            at = None
        cache[f] = at
        return at

    def _materialize(self, items: list, batches: dict[int, dict]) -> Table:
        """Read plan → one concatenated snapshot Table (the shared tail of
        ``read`` and the pruned scan)."""
        paths: list = []              # a part's path, or a sealed Arrow slice
        seg_cache: dict = {}
        for it in items:
            if it[0] == "part":
                bid, e = it[1], it[2]
                if e["rows"] == 0:
                    continue
                p = os.path.join(self.path, e["file"])
                if not os.path.exists(p):
                    raise FileNotFoundError(
                        f"batch {bid} of table {self.name!r} is committed but its "
                        f"part {e['file']} is missing and no sealed segment serves it"
                    )
                paths.append(p)
                continue
            s, run = it[1], it[2]
            offs = _seal_offsets(s)
            at = self._seal_arrow(s, seg_cache)
            if at is not None:
                a, b = offs[run[0]][0], offs[run[-1]][1]
                if b > a:
                    paths.append(at.slice(a, b - a))
                continue
            # rotten segment: serve the run from surviving parts (their
            # bytes are what was sealed — a replay after the seal would
            # have made these bids part-served); any missing part means
            # data loss, which must be loud, never a shorter answer
            for bid in run:
                e = batches.get(bid)
                fname = e["file"] if e else f"part-{bid:010d}.parquet"
                if offs[bid][1] == offs[bid][0]:
                    continue  # sealed empty batch
                p = os.path.join(self.path, fname)
                if not os.path.exists(p):
                    raise SegmentCorruptError(
                        f"sealed segment {s['file']} failed CRC and part"
                        f" {fname} was retired — batch {bid} is"
                        " unrecoverable here; run scrub() to quarantine"
                        " and rebuild what survives"
                    )
                paths.append(p)
        if not paths:
            return Table.empty(self.schema)
        pa = pyarrow_module()
        import pyarrow.parquet as pq

        # schema inferred from the data: committed batches carry derived
        # columns (ingest_time) beyond the declared source schema
        return Table.from_arrow(pa.concat_tables(
            [pq.read_table(p) if isinstance(p, str) else p for p in paths]))

    def read(self, upto_batch_id: int | None = None) -> Table:
        """Snapshot of all committed rows (what the reference's
        ``spark.sql`` over the output table reads, ``:123-128``);
        ``upto_batch_id`` pins it to the batches with id ≤ it.

        Memoized per commit-log state: between appends, every ``read()``
        returns the same ``Table`` object, so its device-column cache
        (``Table.device_column``) survives across queries and a rerun of
        the window query transfers nothing.  An append, or a replay that
        changes any commit entry or part, changes the key and drops the
        snapshot.  Hits and misses count on the process registry as
        ``sql.cache.snapshot.{hit,miss}``.  The snapshot is tagged with
        its origin (``_unbounded_origin``, ``_origin_upto``), which the
        compiled planner follows back to prune sealed segments.
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
        items, batches = self._assembly(upto_batch_id)
        # each part's (size, mtime_ns) is in the key: a replayed batch
        # with the same row count still rewrites its part file
        key = self._assembly_key(items)
        self._memo_keys[upto_batch_id] = (stat, key)
        while len(self._memo_keys) > 8:      # pins come and go; never unbounded
            self._memo_keys.pop(next(iter(self._memo_keys)))
        if key in self._snapshots:
            reg.inc("sql.cache.snapshot.hit")
            t = self._snapshots[key]
        else:
            reg.inc("sql.cache.snapshot.miss")
            t = self._materialize(items, batches)
            while len(self._snapshots) >= 4:
                self._snapshots.pop(next(iter(self._snapshots)))
            self._snapshots[key] = t
        # Table is frozen: these are bookkeeping attributes, not fields
        object.__setattr__(t, "_unbounded_origin", self)
        object.__setattr__(t, "_origin_upto", upto_batch_id)
        return t

    # ------------------------------------------------- sealed-batch view
    def _seg_for(self, batch_id: int) -> dict | None:
        """The committed seal serving ``batch_id`` now, or None when the
        batch is part-served (never sealed, or replayed after its seal).
        Replays the commit log on every call: no cache outlives a log
        change."""
        batches, seals = self._committed_state()
        best = None
        for s in seals:
            for b in s["batches"]:
                if int(b["batch_id"]) == batch_id:
                    if best is None or s["_seq"] > best["_seq"]:
                        best = s
        if best is None:
            return None
        e = batches.get(batch_id)
        if e is not None and e["_seq"] > best["_seq"]:
            return None  # replayed after the seal: the part supersedes
        return best

    def sealed_rows(self, batch_id: int) -> int | None:
        """Row count the committed seal records for ``batch_id`` (None
        when part-served) — the view layer's retraction detector uses it
        to tell 'part retired into a segment, bytes preserved' from 'part
        vanished'."""
        s = self._seg_for(batch_id)
        if s is None:
            return None
        for b in s["batches"]:
            if int(b["batch_id"]) == batch_id:
                return int(b["rows"])
        return None

    def read_sealed_batch(self, batch_id: int) -> Table | None:
        """One batch's rows sliced back out of its sealed segment
        (CRC-verified), or None when the batch is not segment-served or
        was sealed empty.  Rotten bytes raise :class:`SegmentCorruptError`
        — the view layer must rebuild loudly, not fold garbage."""
        s = self._seg_for(batch_id)
        if s is None:
            return None
        a, b = _seal_offsets(s)[batch_id]
        if b == a:
            return None
        at = read_segment(self.segments_dir, s["file"],
                          {"crc32c": s["crc32c"], "size": s["size"]})
        return Table.from_arrow(at.slice(a, b - a))

    # ---------------------------------------------------------- pruning
    def _zones_for(self, seal: dict) -> dict | None:
        """Zone maps from a seal's manifest, cached by manifest stat (None
        → manifest missing/unreadable → that segment is never pruned, only
        scanned)."""
        mfile = seal.get("manifest") or ""
        ck = (mfile, self._part_stat(SEGMENT_DIR + "/" + mfile))
        if ck in self._zone_cache:
            return self._zone_cache[ck]
        man = load_manifest(self.segments_dir, seal["file"])
        zones = man.get("zones") if man else None
        while len(self._zone_cache) >= 16:
            self._zone_cache.pop(next(iter(self._zone_cache)))
        self._zone_cache[ck] = zones
        return zones

    def _prune_items(self, items: list, lowered_filter) -> tuple[list, dict]:
        """Drop segment runs whose zone maps prove no row can match the
        compiled filter.  Conservative: missing manifests and unknown
        predicate shapes always survive."""
        stats = {"segments": 0, "segments_pruned": 0, "rows_pruned": 0, "parts_scanned": 0}
        seen: set[str] = set()
        pruned: set[str] = set()
        keep = []
        for it in items:
            if it[0] == "part":
                stats["parts_scanned"] += 1
                keep.append(it)
                continue
            s, run = it[1], it[2]
            if s["file"] not in seen:
                seen.add(s["file"])
                stats["segments"] += 1
            zones = self._zones_for(s)
            if (lowered_filter is not None and zones is not None
                    and not segment_may_match(zones, lowered_filter)):
                if s["file"] not in pruned:
                    pruned.add(s["file"])
                    stats["segments_pruned"] += 1
                offs = _seal_offsets(s)
                stats["rows_pruned"] += sum(offs[bid][1] - offs[bid][0] for bid in run)
                continue
            keep.append(it)
        return keep, stats

    def prune_stats(self, lowered_filter, upto_batch_id: int | None = None) -> dict:
        """Manifest-only prune preview for ``explain()`` — no segment or
        part bytes are read."""
        items, _ = self._assembly(upto_batch_id)
        _, stats = self._prune_items(items, lowered_filter)
        return stats

    def scan_pruned(self, upto_batch_id: int | None, lowered_filter) -> tuple[Table | None, dict]:
        """Segment-pruned snapshot for the compiled executor: rows whose
        sealed zone maps prove the filter unsatisfiable never leave disk.
        Returns ``(None, stats)`` when nothing survives (the caller builds
        an empty result off the full snapshot's schema); when nothing
        prunes, returns the memoized full snapshot so the device-column
        cache keeps paying off.  Between appends a repeated (filter, pin)
        pair returns the same ``Table`` object (the commit log's stat is
        the memo's key), so its device columns keep hitting too."""
        reg = global_registry()
        stat = self.commit_log_stat()
        fk = (upto_batch_id, repr(lowered_filter))
        hit = self._pruned_fast.get(fk)
        if hit is not None and hit[0] == stat:
            _, t, stats = hit
            if stats["segments_pruned"]:
                reg.inc("table.segments_prune_skipped", stats["segments_pruned"])
            if t is _FULL_SNAPSHOT:
                return self.read(upto_batch_id), stats
            return t, stats

        items, batches = self._assembly(upto_batch_id)
        keep, stats = self._prune_items(items, lowered_filter)

        def memo_fast(t):
            self._pruned_fast[fk] = (stat, t, stats)
            while len(self._pruned_fast) > 8:
                self._pruned_fast.pop(next(iter(self._pruned_fast)))

        if stats["segments_pruned"] == 0:
            memo_fast(_FULL_SNAPSHOT)
            return self.read(upto_batch_id), stats
        reg.inc("table.segments_prune_skipped", stats["segments_pruned"])
        if not keep:
            memo_fast(None)
            return None, stats
        key = (self._assembly_key(keep), repr(lowered_filter))
        if key in self._pruned_cache:
            t = self._pruned_cache[key]
        else:
            t = self._materialize(keep, batches)
            while len(self._pruned_cache) >= 4:
                self._pruned_cache.pop(next(iter(self._pruned_cache)))
            self._pruned_cache[key] = t
        memo_fast(t)
        return t, stats

    # ------------------------------------------------------------- misc
    def num_rows(self) -> int:
        return sum(e["rows"] for e in self.committed_batches().values())

    def max_batch_id(self) -> int:
        entries = self.committed_batches()
        return max(entries) if entries else -1

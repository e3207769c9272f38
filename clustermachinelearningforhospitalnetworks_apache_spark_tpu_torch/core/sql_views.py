"""Incremental streaming SQL: materialized views maintained per
committed batch (the JAX package's ``core/sql_views.py``, with the
partials, the row-level deltas and the full recompute run on ``device=``,
default the card).

A :class:`MaterializedView` registered over an
:class:`~..streaming.unbounded_table.UnboundedTable` is maintained per
**committed batch** — O(batch) per delta — and serves the current answer
from folded mergeable state instead of a history re-scan.

Incrementalizable subset (everything else falls back to a full
recompute, loudly, with the reason visible in ``explain``):

* **aggregate plans** (GROUP BY / whole-table) whose aggregates are
  count/sum/avg/min/max — each batch's rows run the partial aggregate
  (``sql_compile.run_partial_aggregate``: the avg/sum outputs rewritten
  to raw sum+count accumulators) on the device, and the per-batch
  partials fold on the host by addition / monotone min-max;
* **row-level plans** (filter + projection, the reference's watermarked
  time-window extract): each batch's filtered/projected output rows are
  materialized once and the view serves their concatenation.

Not incrementalizable: whole-partition window functions (an appended row
rewrites every row of its partition), LIMIT (order-dependent prefix),
and any plan with interpreter-fallback nodes.

Exactly-once maintenance: view state carries the **last-applied batch
id** plus per-batch commit metadata, so replays never double-apply a
delta — a batch id at or below the high-water mark is skipped unless its
committed entry *changed* (a replayed batch with different content),
which triggers **retraction**: the old delta is dropped and recomputed.
Retraction is watermark-aware: with an event-time watermark attached,
per-batch aggregate partials whose max event time is sealed below the
watermark are compacted into one base partial (bounded state) and can no
longer be individually retracted — a sub-watermark replay forces a loud
full rebuild, mirroring the stream's own late-row contract.  The named
fault site ``sql.view.maintain`` fires before each delta is applied, so a
kill there resumes to a view bit-identical to an uninterrupted run's (the
card's per-group float sums are deterministic, ``sql_compile``).

Durability: state persists as an atomic JSON snapshot (plus one Parquet
file per row-level delta) under ``<table>/_views/<name>/`` — the commit
log remains the source of truth: a crash loses at most the un-persisted
tail, which the next refresh re-derives from the committed parts (or
their sealed segments).  Maintenance and reads never materialize the
full table snapshot; only registration (and a loud rebuild) pays an
O(history) pass.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import replace
from typing import Any

import numpy as np

from ..device import resolve_device
from ..io.model_io import fsync_dir
from ..obs import trace as _trace
from ..obs.registry import global_registry as _global_registry
from ..utils.faults import fault_point
from ..utils.logging import get_logger
from .sql_parse import _Query, parse
from .sql_plan import plan_query
from .table import Table

log = get_logger("sql.views")

# ------------------------------------------------------------- decisions
#: per-clause-node incremental decisions (explain / the registry / tests
#: share these literals)
DECISION_INCREMENTAL = "incremental"
FULL_NOT_COMPILED = "full-recompute:plan-not-compiled"
FULL_WINDOW = "full-recompute:window-over-unbounded-partition"
FULL_LIMIT = "full-recompute:limit-order-dependent"
FULL_COMPILE_DISABLED = "full-recompute:compiled-dispatch-disabled"


def _compiled_sql_enabled() -> bool:
    """The CMLHN_SQL_COMPILE kill switch governs views too: maintenance
    and serves run the compiled executor, so with the switch off views
    stop folding deltas and every read answers via the interpreter full
    recompute."""
    from .sql import _compile_enabled

    return _compile_enabled()


def incremental_decisions(plan) -> list[str]:
    """One decision per plan node (aligned with ``plan.nodes``):
    :data:`DECISION_INCREMENTAL` or a ``full-recompute:<reason>``
    constant — the per-clause view-coverage surface ``explain``
    exposes."""
    if plan is None:
        return []
    out = []
    for n in plan.nodes:
        if not n.supported:
            out.append(FULL_NOT_COMPILED)
        elif n.op == "window":
            out.append(FULL_WINDOW)
        elif n.op == "limit":
            out.append(FULL_LIMIT)
        else:
            out.append(DECISION_INCREMENTAL)
    return out


def plan_is_incremental(plan) -> tuple[bool, list[str]]:
    """→ (maintainable incrementally?, the non-incremental reasons)."""
    ds = incremental_decisions(plan)
    reasons = sorted({d for d in ds if d != DECISION_INCREMENTAL})
    return bool(ds) and not reasons, reasons


# ------------------------------------------------------- fold machinery
def _canon_keys(key_arrays: list, chars: list[str], n: int) -> list[tuple]:
    """Raw per-group key columns → canonical hashable tuples: each
    component ``(is_null, value)`` with floats' NaN folded to ``(1,
    0.0)`` (NaN is not equal to itself — a raw NaN key would never merge
    across batches), string values as ``(0, str)`` with the null (None)
    as ``(1, "")``, and int/timestamp values as plain ints (NaT keeps
    its int64 sentinel, null flag 0, so it sorts first like the compiled
    executor's group order)."""
    out = []
    for g in range(n):
        comps = []
        for arr, ch in zip(key_arrays, chars):
            if ch == "f":
                v = float(arr[g])
                comps.append((1, 0.0) if np.isnan(v) else (0, v))
            elif ch == "s":
                v = arr[g]
                comps.append((1, "") if v is None else (0, str(v)))
            else:
                comps.append((0, int(arr[g])))
        out.append(tuple(comps))
    return out


def _zero_gate_sums(mat: np.ndarray, accs: tuple) -> None:
    """All-null groups report NaN sums from the partial; store them as 0
    so folding stays additive — finalize restores NaN when the matching
    non-null count is 0.  (A genuine NaN sum with count > 0 — inf − inf
    — is kept: full recompute yields NaN there too.)"""
    for j, a in enumerate(accs):
        if a[0] == "s":
            n_idx = accs.index(("n", a[1]))
            col = mat[:, j]
            col[(mat[:, n_idx] == 0) & np.isnan(col)] = 0.0


def _fold(parts, accs: tuple) -> dict:
    """Fold per-batch partials (ascending batch order — the caller's
    contract, which keeps the float addition order identical no matter
    where compaction cut the prefix) into one ``{key: acc_row}`` dict."""
    merged: dict[tuple, np.ndarray] = {}
    for keys, mat in parts:
        m = np.asarray(mat, dtype=np.float64).reshape(len(keys), len(accs))
        for g, key in enumerate(keys):
            cur = merged.get(key)
            if cur is None:
                merged[key] = m[g].copy()
                continue
            for j, a in enumerate(accs):
                if a[0] == "min":
                    cur[j] = np.fmin(cur[j], m[g, j])
                elif a[0] == "max":
                    cur[j] = np.fmax(cur[j], m[g, j])
                else:  # rows / n / s: additive
                    cur[j] += m[g, j]
    return merged


def _default_accs(accs: tuple) -> np.ndarray:
    """The zero-batch accumulator row (whole-table aggregates always
    yield exactly one output row): counts 0, sums 0, min/max NaN."""
    row = np.zeros(len(accs), dtype=np.float64)
    for j, a in enumerate(accs):
        if a[0] in ("min", "max"):
            row[j] = np.nan
    return row


def _group_order(keys: list[tuple], chars: list[str]) -> np.ndarray:
    """Permutation sorting canonical keys into the compiled executor's
    group order: keys ascending, float and string nulls last, NaT first
    (its raw int64 sentinel is the minimum) — ``sql_compile._segments``'
    lexsort conventions replayed on host (string keys are grouped on
    device as sorted-rank codes with the null code last, so value order
    with the null flag dominating replays it exactly)."""
    if not keys:
        return np.empty(0, dtype=np.int64)
    if not chars:
        return np.zeros(len(keys), dtype=np.int64)
    comps = []
    for c in reversed(range(len(chars))):  # lexsort: LAST key is primary
        if chars[c] == "f":
            comps.append(np.array([k[c][1] for k in keys], dtype=np.float64))
            comps.append(np.array([k[c][0] for k in keys], dtype=bool))
        elif chars[c] == "s":
            comps.append(np.array([k[c][1] for k in keys], dtype="U"))
            comps.append(np.array([k[c][0] for k in keys], dtype=bool))
        else:
            comps.append(np.array([k[c][1] for k in keys], dtype=np.int64))
    return np.lexsort(tuple(comps))


def _finalize_aggregate(
    merged: dict, accs: tuple, finalize: tuple, chars: list[str]
) -> Table:
    """Merged accumulators → the plan's output Table, dtype-for-dtype
    what ``sql_compile._run_aggregate`` materializes (count columns
    int64, other aggregates float64, timestamp keys datetime64[ns])."""
    keys = list(merged.keys())
    order = _group_order(keys, chars)
    keys = [keys[i] for i in order]
    if keys:
        mat = np.stack([merged[k] for k in keys], axis=0)
    else:
        mat = np.zeros((0, len(accs)), dtype=np.float64)
    cols: dict[str, np.ndarray] = {}
    for op in finalize:
        if op[0] == "key":
            _, idx, alias = op
            ch = chars[idx]
            nulls = np.array([k[idx][0] for k in keys], dtype=bool)
            if ch == "f":
                v = np.array([k[idx][1] for k in keys], dtype=np.float64)
                v[nulls] = np.nan
                cols[alias] = v
            elif ch == "t":
                v = np.array([k[idx][1] for k in keys], dtype=np.int64)
                cols[alias] = v.view("datetime64[ns]")
            elif ch == "s":
                v = np.empty(len(keys), dtype=object)
                for i, k in enumerate(keys):
                    v[i] = None if k[idx][0] else k[idx][1]
                cols[alias] = v
            else:
                cols[alias] = np.array(
                    [k[idx][1] for k in keys], dtype=np.int64
                )
        elif op[0] in ("rows", "count"):
            _, j, alias = op
            cols[alias] = mat[:, j].astype(np.int64)
        else:
            kind, a_j, n_j, alias = op
            n = mat[:, n_j]
            if kind == "sum":
                cols[alias] = np.where(n > 0, mat[:, a_j], np.nan)
            elif kind == "avg":
                cols[alias] = np.where(
                    n > 0, mat[:, a_j] / np.maximum(n, 1), np.nan
                )
            else:  # min | max: NaN already when n == 0 (fold keeps it)
                cols[alias] = np.where(n > 0, mat[:, a_j], np.nan)
    return Table.from_dict(cols)


# ----------------------------------------------------------- persistence
def _write_json_atomic(path: str, payload: dict) -> None:
    """Atomic durable snapshot — the quarantine-file discipline (tmp +
    fsync + rename + directory fsync; a torn state file must never
    exist, and a power loss must not undo a rename the commit log has
    already outlived)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path))


def _read_json(path: str) -> dict | None:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError, ValueError):
        return None


def _write_parquet_atomic(path: str, table: Table) -> None:
    import pyarrow.parquet as pq

    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    pq.write_table(table.to_arrow(), tmp)
    # fsync bytes + rename + directory: a torn delta heals via
    # recompute, but a delta the state snapshot references must not
    # vanish on power loss after the snapshot landed
    with open(tmp, "rb+") as f:
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path))


def _read_parquet(path: str) -> Table | None:
    import pyarrow.parquet as pq

    try:
        return Table.from_arrow(pq.read_table(path))
    except Exception:  # noqa: BLE001 — a torn delta heals via recompute
        return None


# ------------------------------------------------------------------ view
class MaterializedView:
    """One registered query over an unbounded table, maintained per
    committed batch.

    Thread-safety: one re-entrant lock guards all state; maintenance
    (the stream's commit thread) and serves (query threads) serialize on
    it.  No other lock is ever acquired while it is held (file writes go
    through module-level helpers), so no cross-subsystem lock order can
    form.
    """

    def __init__(
        self,
        name: str,
        query: str,
        source: Any,
        watermark: Any = None,
        device=None,
    ) -> None:
        self.name = name
        self.query = query
        self.source = source
        #: event-time watermark (a ``WatermarkTracker``) — enables the
        #: sealed-prefix compaction of aggregate partials
        self.watermark = watermark
        #: where the partials, the row-level deltas and the full recompute
        #: run (default the card, which must then be present)
        self.device = resolve_device(device)
        node = parse(query)
        if (
            not isinstance(node, _Query)
            or not isinstance(node.table[0], str)
            or node.joins
        ):
            # joins too: the single-name resolver can't answer the other
            # side, so a join view would register fine and then KeyError
            # on every read — fail at registration instead
            raise ValueError(
                f"view {name!r}: the query must be a single-table SELECT "
                "over the unbounded table"
            )
        self.table_name = node.table[0]
        self.state_dir = os.path.join(source.path, "_views", name)
        self._state_path = os.path.join(self.state_dir, "state.json")

        self._lock = threading.RLock()
        # writer-only serialization for state persistence: readers never
        # touch it, so disk I/O can't stall serves on the main lock
        self._io_lock = threading.Lock()
        self._persisted_epoch = -1
        self._plan: Any = None
        self.fingerprint: str | None = None
        self.decisions: list[str] = []
        self.incremental = False
        self.kind: str | None = None
        self._poisoned: str | None = None   # reason a batch refused to plan
        self._last_applied = -1
        self._batches: dict[int, dict] = {}
        self._base: dict | None = None      # compacted sealed prefix
        self._delta_cache: dict[int, Table] = {}
        self._serve_memo: dict = {}
        self._epoch = 0
        #: commit-log (size, mtime_ns) at the last COMPLETED reconcile —
        #: an unchanged stat lets per-query refreshes skip the O(batches)
        #: log parse + part stats (never persisted: a restart must pay
        #: one full reconcile)
        self._reconciled_log_stat: tuple[int, int] | None = None
        self._load_state()

    # ------------------------------------------------------------ planning
    def _resolver(self, table: Table):
        def resolve(nm: str) -> Table:
            if nm != self.table_name:
                raise KeyError(
                    f"view {self.name!r} is over {self.table_name!r}; the "
                    f"query references {nm!r}"
                )
            return table

        return resolve

    def _ensure_plan(self, snapshot: Table | None = None) -> None:
        """(Re)lower the query.  Cheap host work when a snapshot is
        handed in (the dispatcher already materialized one); the
        no-snapshot path reads the source ONCE (registration / first use
        after restart) and then keeps the lowered plan — maintenance
        never re-materializes history."""
        if self._plan is not None and snapshot is None:
            return
        table = snapshot if snapshot is not None else self.source.read()
        node = parse(self.query)
        plan = (
            plan_query(node, self._resolver(table))
            if isinstance(node, _Query)
            else None
        )
        self._plan = plan
        self.decisions = incremental_decisions(plan)
        ok, _reasons = plan_is_incremental(plan)
        self.incremental = ok and self._poisoned is None
        self.kind = plan.kind if plan is not None else None
        self.fingerprint = plan.fingerprint if plan is not None else None

    def _plan_for_batch(self, table: Table) -> Any:
        node = parse(self.query)
        if not isinstance(node, _Query):
            return None
        plan = plan_query(node, self._resolver(table))
        if (
            plan is None
            or not plan.fully_supported
            or plan.kind != self.kind
            # key dtype CHARS too, not just the count: an int group key
            # drifting to float would make _canon_keys int() a NaN —
            # drift must poison the view, never crash refresh
            or [ch for _, ch in plan.group_keys] != self._key_chars()
        ):
            return None
        return plan

    def _key_chars(self) -> list[str]:
        return [ch for _, ch in self._plan.group_keys] if self._plan else []

    # ----------------------------------------------------------- refresh
    def refresh(self, snapshot: Table | None = None) -> None:
        """Catch up with the commit log: apply every committed batch past
        the last-applied id exactly once, retract + reapply replayed
        batches, compact sealed partials, persist.  Idempotent; O(delta)
        when nothing was replayed."""
        if not _compiled_sql_enabled():
            return  # kill switch: no compiled executor, no delta folds
        pending_files: list[tuple[str, Table]] = []
        payload = None
        with self._lock:
            self._ensure_plan(snapshot)
            if not self.incremental:
                return
            # cheap change detector first (stat BEFORE parse: a commit
            # landing between the two costs one redundant reconcile on
            # the next refresh, never a missed one) — the per-query
            # serve_for refresh must not pay an O(batches) log parse +
            # part-stat sweep when nothing committed since the last one
            log_stat = self.source.commit_log_stat()
            if log_stat == self._reconciled_log_stat:
                return
            entries = self.source.committed_batches()
            dirty = self._retract_changed(entries)
            pending = [
                bid
                for bid in sorted(entries)
                if bid not in self._batches
                and (self._base is None or bid > self._base["upto"])
            ]
            if pending:
                sp = _trace.span("sql.view.maintain")
                with sp:
                    if sp.trace_id is not None:
                        sp.note("view", self.name)
                        sp.note("batches", len(pending))
                    for bid in pending:
                        if not self._apply(bid, entries[bid], pending_files):
                            break  # a batch refused to plan: poisoned
                dirty = True
            if self._compact():
                dirty = True
            if self.incremental:
                # reconcile completed (a poisoned break leaves the stat
                # unset — moot anyway: the next refresh early-returns on
                # not-incremental; a chaos kill raised past this line)
                self._reconciled_log_stat = log_stat
            if dirty:
                payload = self._persist_payload()
        if payload is None:
            return
        # persistence is STAGED under the lock, performed after release
        # (blocking-under-lock discipline: a delta parquet + state fsync
        # must not stall concurrent serves).  Delta paths are
        # epoch-qualified, so an overtaken writer's parquet writes can
        # only create orphans, never clobber a reapplied batch's file;
        # only state.json carries the epoch guard, so overtaken writers
        # can't regress it.  Any torn combination still heals from the
        # commit log on the next refresh — the log is the truth.
        with self._io_lock:
            for path, tbl in pending_files:
                # _io_lock exists to serialize this IO; serves take only _lock
                _write_parquet_atomic(path, tbl)
            if payload["epoch"] >= self._persisted_epoch:
                _write_json_atomic(self._state_path, payload)
                self._persisted_epoch = payload["epoch"]
                self._sweep_orphan_deltas(payload)

    def _sweep_orphan_deltas(self, payload: dict) -> None:
        """Unlink delta files the JUST-WRITTEN state does not reference
        (io_lock held): retract-and-reapply and overtaken writers leave
        epoch-qualified orphans behind.  Only the thread that actually
        landed state.json sweeps — an epoch-blocked writer's stale
        payload must never delete files a newer state references."""
        live = {
            e.get("delta_file") for e in payload["batches"].values()
        }
        try:
            names = os.listdir(self.state_dir)
        except OSError:
            return
        for f in names:
            if (
                f.startswith("delta-")
                and f.endswith(".parquet")
                and f not in live
            ):
                try:
                    os.unlink(os.path.join(self.state_dir, f))
                except OSError:
                    pass  # best effort; an orphan is harmless

    def _retract_changed(self, entries: dict) -> bool:
        """Drop deltas whose committed entry (or part-file bytes) changed
        — a replayed batch.  A replay under the compacted base forces a
        loud full rebuild (the watermark sealed it)."""
        dirty = False
        if self._base is not None:
            for bid, meta in list(self._base["sealed"].items()):
                e = entries.get(bid)
                if e is None or self._entry_changed(e, meta):
                    log.warning(
                        "sealed batch replayed below the watermark; "
                        "rebuilding view from the commit log",
                        view=self.name, batch_id=bid,
                    )
                    self._reset_state()
                    _global_registry().inc("sql.view.rebuilds")
                    return True
            # a NEW commit-log entry below the seal that was never sealed
            # (a gap-fill replay): refresh's pending filter only looks
            # above the seal, so without this check its rows would be
            # silently dropped from view state while a full recompute
            # includes them — same loud-rebuild contract as a sealed
            # replay (folding it out of batch order would also break the
            # bit-identical float addition order)
            upto = self._base["upto"]
            for bid in entries:
                if bid <= upto and bid not in self._base["sealed"]:
                    log.warning(
                        "commit log gained a batch below the compacted "
                        "seal; rebuilding view from the commit log",
                        view=self.name, batch_id=bid,
                    )
                    self._reset_state()
                    _global_registry().inc("sql.view.rebuilds")
                    return True
        for bid in sorted(self._batches):
            e = entries.get(bid)
            if e is not None and not self._entry_changed(e, self._batches[bid]):
                continue
            _global_registry().inc("sql.view.retractions")
            log.info(
                "retracting replayed batch from view",
                view=self.name, batch_id=bid,
            )
            self._batches.pop(bid, None)
            self._delta_cache.pop(bid, None)
            self._epoch += 1
            dirty = True
        return dirty

    def _entry_changed(self, entry: dict, meta: dict) -> bool:
        if entry["file"] != meta["file"] or int(entry["rows"]) != meta["rows"]:
            return True
        # ONE copy of the content-identity rule: the source's own
        # replay detector (also the snapshot-memo key), so the two can
        # never disagree about whether a replay happened
        size, mtime = self.source._part_stat(entry["file"])
        if size < 0:
            # part file gone: retention may have retired it into a
            # sealed segment — the bytes are preserved, so
            # the folded delta is still exact and retracting it would
            # force a rebuild on every refresh forever
            if self.source.sealed_rows(int(entry["batch_id"])) == int(entry["rows"]):
                return False
        return [size, mtime] != list(meta.get("stat", (size, mtime)))

    def _apply(
        self, bid: int, entry: dict, pending_files: list
    ) -> bool:
        """Apply one committed batch's delta exactly once.  The named
        fault site fires FIRST: a kill here leaves the batch committed
        but unapplied, and the next refresh picks it up — never twice.
        Row-level delta files are always staged into ``pending_files``
        for the caller to write after the lock drops."""
        fault_point("sql.view.maintain", view=self.name, batch_id=bid)
        meta: dict = {
            "file": entry["file"],
            "rows": int(entry["rows"]),   # commit-entry identity
            "stat": list(self.source._part_stat(entry["file"])),
            "max_event_ns": None,
        }
        tbl = self._read_part(entry)
        # folded_rows = rows ACTUALLY folded, which the freshness check
        # sums against len(snapshot): a missing/torn part contributes 0
        # to both (UnboundedTable.read skips it too) — counting the
        # entry's rows instead would fail freshness forever and silently
        # disable dispatcher serves
        meta["folded_rows"] = int(len(tbl)) if tbl is not None else 0
        if tbl is not None and len(tbl):
            meta["max_event_ns"] = self._max_event_ns(tbl)
            bplan = self._plan_for_batch(tbl)
            if bplan is None:
                self._poisoned = (
                    f"batch {bid} no longer lowers to the incremental "
                    "subset (schema drift)"
                )
                self.incremental = False
                log.warning(
                    "view poisoned: falling back to full recompute",
                    view=self.name, batch_id=bid,
                )
                return False
            if bplan.outputs != self._plan.outputs:
                # the table gained columns since the plan was lowered (a
                # SELECT * registered over an empty sink, then ingest_time
                # arrived): follow the batch's lowering, so an answer with
                # no rows yet still has the snapshot's columns
                self._plan = replace(bplan, source=None)
                self.fingerprint = bplan.fingerprint
            if self.kind == "aggregate":
                from .sql_compile import run_partial_aggregate

                keys, mat, accs = run_partial_aggregate(bplan, tbl, device=self.device)
                ckeys = _canon_keys(keys, self._key_chars(), mat.shape[0])
                _zero_gate_sums(mat, accs)
                meta["keys"] = ckeys
                meta["accs"] = mat
            else:
                from .sql_compile import run_plan

                delta = run_plan(bplan, tbl, device=self.device)
                meta["rows_out"] = len(delta)
                if len(delta):
                    # epoch-qualified name: a retract-and-reapply gets a
                    # FRESH path, so an overtaken writer's staged delta
                    # (written outside the lock) can only ever land as
                    # an unreferenced orphan — never overwrite the
                    # reapplied batch's file with pre-replay rows
                    fname = f"delta-{bid:010d}-{self._epoch + 1:08d}.parquet"
                    fpath = os.path.join(self.state_dir, fname)
                    pending_files.append((fpath, delta))
                    meta["delta_file"] = fname
                    self._delta_cache[bid] = delta
                else:
                    meta["delta_file"] = None
        elif self.kind == "rowlevel":
            meta["rows_out"] = 0
            meta["delta_file"] = None
        self._batches[bid] = meta
        self._last_applied = max(self._last_applied, bid)
        self._epoch += 1
        _global_registry().inc("sql.view.maintained")
        return True

    def _read_part(self, entry: dict) -> Table | None:
        if int(entry["rows"]) == 0:
            return None
        p = os.path.join(self.source.path, entry["file"])
        if not os.path.exists(p):
            # retention may have retired the part into a sealed segment:
            # fold the CRC-verified sealed slice, so a view registered
            # after retirement still covers full history (rotten bytes
            # raise SegmentCorruptError, which refresh surfaces).  A
            # missing part that no segment serves is data loss and raises,
            # as the table's read() does.
            bid = int(entry["batch_id"])
            if self.source.sealed_rows(bid) is None:
                raise FileNotFoundError(
                    f"view {self.name!r}: batch {bid} is committed but its part "
                    f"{entry['file']} is missing and no sealed segment serves it"
                )
            return self.source.read_sealed_batch(bid)
        return _read_parquet(p)

    def _max_event_ns(self, table: Table) -> int | None:
        col = getattr(self.watermark, "column", None)
        if col is None or col not in table.columns:
            return None
        v = table.column(col)
        if v.dtype.kind != "M":
            return None
        v = v[~np.isnat(v)]
        if not v.size:
            return None
        return int(v.max().astype("datetime64[ns]").astype(np.int64))

    def _compact(self) -> bool:
        """Fold aggregate partials sealed below the watermark into the
        base partial — bounded state for 24/7 streams; those batches can
        no longer be individually retracted (the late-row contract)."""
        if self.kind != "aggregate" or self.watermark is None:
            return False
        wm = getattr(self.watermark, "watermark", None)
        if wm is None:
            return False
        wm_ns = int(np.datetime64(wm, "ns").astype(np.int64))
        sealed: list[int] = []
        for bid in sorted(self._batches):
            m = self._batches[bid]
            # an EMPTY committed batch (all rows dropped as late, or a
            # part file gone missing — folded 0) has no event time but
            # must still seal — otherwise it blocks the contiguous
            # prefix forever and state grows with history.  Same stance
            # for a non-empty batch with NO resolvable event time (all-
            # NaT column): it can never fall below the watermark, so
            # waiting on it would wedge compaction for the stream's
            # lifetime — seal it; a replay just costs the loud rebuild
            if m.get("folded_rows", m["rows"]) and (
                m["max_event_ns"] is not None and m["max_event_ns"] >= wm_ns
            ):
                break  # compaction folds a contiguous prefix only
            sealed.append(bid)
        if not sealed:
            return False
        _p, accs, _f = self._partial_spec()
        parts = []
        if self._base is not None:
            parts.append((self._base["keys"], self._base["accs"]))
        rows = self._base["rows"] if self._base is not None else 0
        sealed_meta = dict(self._base["sealed"]) if self._base else {}
        for bid in sealed:
            m = self._batches[bid]
            if "keys" in m:
                parts.append((m["keys"], m["accs"]))
            rows += m.get("folded_rows", m["rows"])  # freshness accounting
            sealed_meta[bid] = {
                "file": m["file"], "rows": m["rows"], "stat": m["stat"],
            }
        merged = _fold(parts, accs)
        keys = list(merged.keys())
        self._base = {
            "upto": sealed[-1],
            "rows": rows,
            "sealed": sealed_meta,
            "keys": keys,
            "accs": np.stack([merged[k] for k in keys], axis=0)
            if keys else np.zeros((0, len(accs))),
        }
        for bid in sealed:
            del self._batches[bid]
        self._epoch += 1
        return True

    def _reset_state(self) -> None:
        self._batches.clear()
        self._delta_cache.clear()
        self._serve_memo.clear()
        self._base = None
        self._last_applied = -1
        self._epoch += 1
        # a reset outside refresh (a serve-path heal) must force the
        # next refresh to reconcile even though the log never changed
        self._reconciled_log_stat = None

    def _partial_spec(self):
        from .sql_compile import partial_plan_outputs

        return partial_plan_outputs(self._plan.outputs, self._plan.group_keys)

    # ------------------------------------------------------------- serve
    def _folded_rows(self) -> int:
        """Rows ACTUALLY folded into state (lock held) — sums
        ``folded_rows`` so a skipped missing/torn part counts 0, exactly
        like the snapshot read it is compared against."""
        base = self._base["rows"] if self._base is not None else 0
        return base + sum(
            m.get("folded_rows", m["rows"])
            for m in list(self._batches.values())
        )

    def applied_rows(self) -> int:
        """Source rows folded into the current state — the freshness
        check the dispatcher compares against its snapshot length."""
        with self._lock:
            return self._folded_rows()

    def serve_if_fresh(self, plan) -> Table | None:
        """Snapshot-consistent serve for the dispatcher: fingerprint +
        row-count freshness verified AND the answer materialized under
        ONE lock hold — a batch committing mid-serve can never leak rows
        the plan's snapshot did not contain, and (the caller just
        refreshed via ``serve_for``) no second O(history) commit-log
        reconcile is paid per query on the hot path."""
        sp = _trace.span("sql.view.serve")
        with sp:
            with self._lock:
                if (
                    not self.incremental
                    or self.fingerprint != plan.fingerprint
                ):
                    return None
                if self._folded_rows() != len(plan.source):
                    return None
                if sp.trace_id is not None:
                    sp.note("view", self.name)
                    sp.note("mode", "incremental")
                return self._serve_locked(self._last_applied)

    def read(self, upto_batch_id: int | None = None) -> Table:
        """The view's current answer (or, pinned, the answer at batches
        ≤ ``upto_batch_id`` — the lifecycle retrain's journaled snapshot
        pin).  Refreshes first, so direct readers always see every
        committed batch; non-incrementalizable plans (and the
        CMLHN_SQL_COMPILE=0 kill switch) fall back to a loud full
        recompute and stay correct."""
        sp = _trace.span("sql.view.serve")
        with sp:
            self.refresh()
            with self._lock:
                if sp.trace_id is not None:
                    sp.note("view", self.name)
                    sp.note(
                        "mode",
                        "incremental" if self.incremental else "full",
                    )
                return self._serve_locked(upto_batch_id)

    def _serve_locked(self, upto: int | None) -> Table:
        """Materialize the answer from current state (lock held)."""
        if not self.incremental or not _compiled_sql_enabled():
            return self._full_recompute(upto, loud=True)
        if (
            upto is not None
            and self._base is not None
            and upto < self._base["upto"]
        ):
            # pinned below the compacted prefix: state is gone
            return self._full_recompute(upto, loud=True)
        key = (self._epoch, upto)
        hit = self._serve_memo.get(key)
        if hit is not None:
            return hit
        if self.kind == "aggregate":
            out = self._materialize_aggregate(upto)
        else:
            out = self._materialize_rowlevel(upto)
        while len(self._serve_memo) >= 4:
            self._serve_memo.pop(next(iter(self._serve_memo)))
        self._serve_memo[key] = out
        return out

    def _materialize_aggregate(self, upto: int | None) -> Table:
        _p, accs, fin = self._partial_spec()
        parts = []
        if self._base is not None:
            parts.append((self._base["keys"], self._base["accs"]))
        for bid in sorted(self._batches):
            if upto is not None and bid > upto:
                continue
            m = self._batches[bid]
            if "keys" in m:
                parts.append((m["keys"], m["accs"]))
        for keys, mat in parts:
            if np.asarray(mat, dtype=np.float64).size != (
                len(keys) * len(accs)
            ):
                # plan shape drifted under persisted state: heal loudly
                self._reset_state()
                _global_registry().inc("sql.view.rebuilds")
                return self._full_recompute(upto, loud=True)
        merged = _fold(parts, accs)
        chars = self._key_chars()
        if not chars and not merged:
            merged[()] = _default_accs(accs)
        return _finalize_aggregate(merged, accs, fin, chars)

    def _materialize_rowlevel(self, upto: int | None) -> Table:
        tables: list[Table] = []
        for bid in sorted(self._batches):
            if upto is not None and bid > upto:
                continue
            m = self._batches[bid]
            if not m.get("rows_out"):
                continue
            t = self._delta_cache.get(bid)
            if t is None:
                t = _read_parquet(
                    os.path.join(self.state_dir, m["delta_file"])
                )
                if t is None:  # torn/missing delta: re-derive it
                    self._batches.pop(bid, None)
                    self._epoch += 1
                    self._reconciled_log_stat = None
                    return self._full_recompute(upto, loud=True)
                self._delta_cache[bid] = t
            tables.append(t)
        if not tables:
            return self._empty_rowlevel()
        if any(
            list(t.columns) != list(tables[0].columns) for t in tables[1:]
        ):
            self._reset_state()
            _global_registry().inc("sql.view.rebuilds")
            return self._full_recompute(upto, loud=True)
        return Table.concat(tables) if len(tables) > 1 else tables[0]

    def _empty_rowlevel(self) -> Table:
        """The zero-matching-rows answer synthesized from the plan's
        lowered dtypes — NO history scan (a filter that matches nothing
        yet must not cost O(history) per commit)."""
        types = dict(self._plan.col_types)
        cols: dict[str, np.ndarray] = {}
        for o in self._plan.outputs:
            if o[0] == "pass":
                ch, alias = types.get(o[1], "s"), o[2]
            else:
                ch, alias = o[-1], o[-2]
            if ch == "f":
                cols[alias] = np.empty(0, np.float64)
            elif ch == "i":
                cols[alias] = np.empty(0, np.int64)
            elif ch == "t":
                cols[alias] = np.empty(0, "datetime64[ns]")
            else:
                cols[alias] = np.empty(0, object)
        return Table.from_dict(cols)

    def _full_recompute(self, upto: int | None, loud: bool) -> Table:
        from .sql import execute

        if loud:
            _global_registry().inc("sql.view.full_recompute")
            reasons = [
                d for d in self.decisions if d != DECISION_INCREMENTAL
            ]
            if self._poisoned:
                reasons.append(self._poisoned)
            if not _compiled_sql_enabled():
                reasons.append(FULL_COMPILE_DISABLED)
            log.warning(
                "materialized view serving a FULL RECOMPUTE",
                view=self.name, reasons=reasons or ["state-unavailable"],
            )
        snap = self.source.read(upto_batch_id=upto)
        return execute(self.query, self._resolver(snap), device=self.device)

    # ------------------------------------------------------- persistence
    def _persist_payload(self) -> dict:
        def keys_json(keys):
            return [[list(c) for c in k] for k in keys]

        batches: dict[str, dict] = {}
        for bid in sorted(self._batches):
            m = self._batches[bid]
            e: dict = {
                "file": m["file"], "rows": m["rows"], "stat": m["stat"],
                "folded_rows": m.get("folded_rows", m["rows"]),
                "max_event_ns": m["max_event_ns"],
            }
            if "keys" in m:
                e["keys"] = keys_json(m["keys"])
                e["accs"] = np.asarray(m["accs"]).tolist()
            if self.kind == "rowlevel":
                e["rows_out"] = m.get("rows_out", 0)
                e["delta_file"] = m.get("delta_file")
            batches[str(bid)] = e
        base = None
        if self._base is not None:
            base = {
                "upto": self._base["upto"],
                "rows": self._base["rows"],
                "sealed": {
                    str(b): meta
                    for b, meta in self._base["sealed"].items()
                },
                "keys": keys_json(self._base["keys"]),
                "accs": np.asarray(self._base["accs"]).tolist(),
            }
        return {
            "version": 1,
            "name": self.name,
            "query": self.query,
            "kind": self.kind,
            "fingerprint": self.fingerprint,
            "key_chars": "".join(self._key_chars()),
            "last_applied": self._last_applied,
            "epoch": self._epoch,  # writer-ordering guard, not loaded
            "base": base,
            "batches": batches,
        }

    def _load_state(self) -> None:
        payload = _read_json(self._state_path)
        if not payload or payload.get("query") != self.query:
            return
        chars = payload.get("key_chars", "")

        def keys_load(ks):
            def comp(c, ch):
                if ch == "f":
                    return (int(c[0]), float(c[1]))
                if ch == "s":
                    return (int(c[0]), str(c[1]))
                return (int(c[0]), int(c[1]))

            return [
                tuple(comp(c, ch) for c, ch in zip(k, chars)) for k in ks
            ]

        self._last_applied = int(payload.get("last_applied", -1))
        self.fingerprint = payload.get("fingerprint")
        for bid_s, e in payload.get("batches", {}).items():
            m: dict = {
                "file": e["file"], "rows": int(e["rows"]),
                "stat": list(e.get("stat", (-1, -1))),
                "folded_rows": int(e.get("folded_rows", e["rows"])),
                "max_event_ns": e.get("max_event_ns"),
            }
            if "keys" in e:
                # kept 1-D/raw: _fold reshapes to (groups, accs) and the
                # materialize guard size-checks against the CURRENT plan
                # (a reshape here would crash on zero-group/zero-acc
                # partials and bake in a possibly-stale acc width)
                m["keys"] = keys_load(e["keys"])
                m["accs"] = np.asarray(e["accs"], dtype=np.float64)
            if "rows_out" in e:
                m["rows_out"] = int(e["rows_out"])
                m["delta_file"] = e.get("delta_file")
            self._batches[int(bid_s)] = m
        b = payload.get("base")
        if b is not None:
            self._base = {
                "upto": int(b["upto"]),
                "rows": int(b["rows"]),
                "sealed": {
                    int(k): v for k, v in b.get("sealed", {}).items()
                },
                "keys": keys_load(b["keys"]),
                "accs": np.asarray(b["accs"], dtype=np.float64),
            }

    # ---------------------------------------------------------- explain
    def describe(self) -> dict:
        """Observable summary (tests / operators): mode, decisions,
        high-water mark, state shape."""
        with self._lock:
            return {
                "name": self.name,
                "table": self.table_name,
                "kind": self.kind,
                "incremental": self.incremental,
                "decisions": list(self.decisions),
                "poisoned": self._poisoned,
                "fingerprint": self.fingerprint,
                "last_applied": self._last_applied,
                "batches_retained": len(self._batches),
                "compacted_upto": (
                    self._base["upto"] if self._base is not None else None
                ),
                "applied_rows": self.applied_rows(),
            }


# -------------------------------------------------------------- registry
class ViewRegistry:
    """Session-scoped registry: name → :class:`MaterializedView`, plus
    the two integration surfaces — the stream's post-commit maintenance
    hook and the SQL dispatcher's fingerprint-matched serve.  Every view
    it registers computes on ``device`` (default the card, which must
    then be present)."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self._views: dict[str, MaterializedView] = {}
        self._lock = threading.Lock()

    def register(
        self, name: str, query: str, source: Any, watermark: Any = None
    ) -> MaterializedView:
        view = MaterializedView(name, query, source, watermark=watermark, device=self.device)
        with self._lock:
            if name in self._views:
                raise ValueError(f"view {name!r} already registered")
            self._views[name] = view
        view.refresh()  # catch up on pre-existing committed batches
        return view

    def get(self, name: str) -> MaterializedView:
        with self._lock:
            v = self._views.get(name)
        if v is None:
            raise KeyError(
                f"unknown view {name!r}; registered: {self.names()}"
            )
        return v

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._views)

    def __len__(self) -> int:
        with self._lock:
            return len(self._views)

    def maintain(self, sink: Any, batch_id: int | None = None) -> None:
        """The commit-path hook (``streaming/microbatch.py`` calls this
        right after a batch's commit record lands): every view over the
        sink folds the newly committed delta in — O(batch), exactly
        once (replays and resumed crashes skip on the high-water
        mark).  ``batch_id`` is advisory context only — maintenance
        always reconciles against the FULL commit log, because the hook
        may also be the first to observe replays or batches a killed
        incarnation committed but never folded."""
        path = os.path.abspath(getattr(sink, "path", ""))
        for v in list(self._views.values()):
            if os.path.abspath(v.source.path) == path:
                v.refresh()

    def serve_for(self, plan) -> Table | None:
        """Dispatcher integration: a fresh view whose plan fingerprint
        matches answers the query from folded state.  ``None`` = no
        match (the dispatcher falls through to the compiled path);
        ``sql.view.{hit,miss}`` count the outcomes."""
        cands = [
            v
            for v in list(self._views.values())
            if v.table_name == plan.table
        ]
        if not cands:
            return None  # no views over this table: not a miss
        for v in cands:
            if not v.incremental:
                continue
            # steady state (fingerprints already equal): plain catch-up,
            # no re-lowering per query.  On mismatch, replan against the
            # dispatcher's snapshot (already materialized — no extra
            # history pass) so dtype promotion can't strand the match.
            v.refresh(
                snapshot=None
                if v.fingerprint == plan.fingerprint
                else plan.source
            )
            out = v.serve_if_fresh(plan)
            if out is not None:
                _global_registry().inc("sql.view.hit")
                return out
        _global_registry().inc("sql.view.miss")
        return None

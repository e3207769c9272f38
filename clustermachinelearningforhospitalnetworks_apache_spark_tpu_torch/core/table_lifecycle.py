"""Watermark-driven lifecycle for the unbounded table's history (the JAX
package's ``core/table_lifecycle.py``: the same commit-log entries and
segment layout, so a table sealed by either package reads the same in the
other).

Three idempotent passes over the commit log:

* ``seal()`` — compact cold committed batches into CRC-manifested
  columnar segments (``core/segments.py``).  Stage-then-commit: segment
  data + manifest are staged under the ``table.seal.stage`` fault site,
  then one fsync'd commit-log line (``table.seal.commit``) makes the
  seal real.  A kill anywhere before the commit line leaves only orphan
  staged files that the next pass re-stages under the same names
  (candidates and names derive from the log alone).
* ``retire()`` — delete part files whose bytes a CRC-verified committed
  segment now serves.  Log-first (``table.retire.commit`` → append →
  unlink → dirsync): a kill between the entry and the unlinks just
  re-retires on resume; duplicate retire entries are audit noise, not
  state.
* ``scrub()`` — re-verify every committed segment's bytes against the
  CRC32C in its seal entry.  Rot → quarantine the segment
  (``table.scrub.repair``), rebuild it from surviving parts when they
  all still exist, else record the quarantine and raise a typed
  :class:`~.segments.SegmentCorruptError` — never a silent wrong answer,
  never a quiet row-count shrink.

This module makes decisions; every byte of durable segment IO lives in
:mod:`.segments`, and every state transition is one WAL append to the
table's commit log.  All of it is host work and takes no ``device=``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..io.integrity import verify_bytes
from ..io.model_io import fsync_dir
from ..obs.registry import global_registry
from ..obs.trace import span
from ..tune import knob
from ..utils.faults import fault_point
from .segments import (
    SegmentCorruptError,
    manifest_name,
    pyarrow_module,
    quarantine_segment,
    write_segment,
)
from .table import Table

@dataclass(frozen=True)
class RetentionPolicy:
    """What to seal and when to let go of the hot copies.

    ``hot_batches`` newest committed batches are never sealed (they are
    the replay-prone tail); a seal needs at least ``min_seal_batches``
    cold candidates to be worth a segment; ``max_segment_batches`` bounds
    segment size so one seal never rewrites unbounded history;
    ``retire_parts=False`` keeps part files forever (segments as pure
    acceleration).

    The seal chunk knobs (``table.seal.min_batches`` /
    ``table.seal.max_segment_batches``) are registry-owned: ``None``
    resolves through :func:`tune.knob` when the policy is built, so a
    frozen policy pins one value for its lifetime — segment boundaries
    never move between two passes of the same policy.
    """

    min_seal_batches: int | None = None
    hot_batches: int = 2
    max_segment_batches: int | None = None
    retire_parts: bool = True
    #: column whose per-part max must fall below the seal watermark for a
    #: batch to count as cold (None → age by batch id alone)
    watermark_column: str | None = None

    def __post_init__(self) -> None:
        # frozen dataclass: resolve the knob-owned fields once, at build
        if self.min_seal_batches is None:
            object.__setattr__(
                self, "min_seal_batches", int(knob("table.seal.min_batches")))
        if self.max_segment_batches is None:
            object.__setattr__(
                self, "max_segment_batches", int(knob("table.seal.max_segment_batches")))


def _as_ns(watermark) -> int:
    if isinstance(watermark, (int, np.integer)):
        return int(watermark)
    return int(np.datetime64(watermark).astype("datetime64[ns]").astype(np.int64))


def _seal_entry(first: int, last: int, manifest: dict, seal_batches: list) -> dict:
    """The commit-log line that makes a staged segment real."""
    return {
        "seal": {
            "first": int(first),
            "last": int(last),
            "file": manifest["file"],
            "manifest": manifest_name(manifest["file"]),
            "rows": int(manifest["rows"]),
            "batches": seal_batches,
            "crc32c": manifest["data"]["crc32c"],
            "size": manifest["data"]["size"],
        }
    }


class TableLifecycle:
    """Seal, retire and scrub passes over one ``UnboundedTable``."""

    def __init__(self, table, policy: RetentionPolicy | None = None):
        self.table = table
        self.policy = policy or RetentionPolicy()

    # ---------------------------------------------------------- helpers
    def _read_part_arrow(self, entry: dict):
        """Arrow table of a committed part, or None when the file is gone
        or the entry is empty — sealed as 0 rows."""
        if int(entry.get("rows", 0)) <= 0:
            return None
        p = os.path.join(self.table.path, entry["file"])
        if not os.path.exists(p):
            return None
        pyarrow_module()
        import pyarrow.parquet as pq

        return pq.read_table(p)

    def _is_cold(self, entry: dict, wm_ns: int | None) -> bool:
        """Watermark coldness: the part's max event time is strictly below
        the watermark.  No watermark column / no watermark value → age by
        position alone; a missing part or column cannot get any hotter,
        so it counts as cold."""
        col = self.policy.watermark_column
        if col is None or wm_ns is None:
            return True
        p = os.path.join(self.table.path, entry["file"])
        if int(entry.get("rows", 0)) <= 0 or not os.path.exists(p):
            return True
        pyarrow_module()
        import pyarrow.parquet as pq

        try:
            at = pq.read_table(p, columns=[col])
        except Exception:
            return True
        v = at.column(col).to_numpy(zero_copy_only=False)
        if v.size == 0:
            return True
        return int(v.view("i8").max()) < wm_ns

    def _verify_seal_bytes(self, seal: dict) -> bool:
        """Full-bytes CRC check of a committed segment (no Parquet parse):
        retire refuses to delete parts a rotten segment claims to
        serve."""
        p = os.path.join(self.table.segments_dir, seal["file"])
        try:
            with open(p, "rb") as f:
                data = f.read()
        except OSError:
            return False
        return verify_bytes(data, {"crc32c": seal["crc32c"], "size": seal["size"]}) is None

    def _concat(self, parts: list) -> Table:
        if not parts:
            return Table.empty(self.table.schema)
        return Table.from_arrow(pyarrow_module().concat_tables(parts))

    # ------------------------------------------------------------- seal
    def seal(self, watermark=None) -> int:
        """Compact cold committed batches into sealed segments; returns how
        many segments were committed this pass."""
        pol = self.policy
        wm_ns = None if watermark is None else _as_ns(watermark)
        sealed = 0
        with span("table.seal"):
            batches, seals = self.table._committed_state()
            covered: set[int] = set()
            for s in seals:
                covered.update(int(b["batch_id"]) for b in s["batches"])
            all_bids = sorted(batches)
            hot = (set(all_bids[max(0, len(all_bids) - pol.hot_batches):])
                   if pol.hot_batches else set())
            candidates = [
                bid for bid in all_bids
                if bid not in covered and bid not in hot
                and self._is_cold(batches[bid], wm_ns)
            ]
            for i in range(0, len(candidates), pol.max_segment_batches):
                chunk = candidates[i:i + pol.max_segment_batches]
                if len(chunk) < pol.min_seal_batches:
                    continue
                sealed += self._seal_chunk(chunk, batches)
        return sealed

    def _seal_chunk(self, chunk: list[int], batches: dict[int, dict]) -> int:
        parts = []
        seal_batches = []
        for bid in chunk:
            at = self._read_part_arrow(batches[bid])
            rows = 0 if at is None else at.num_rows
            if at is not None and rows > 0:
                parts.append(at)
            seal_batches.append({"batch_id": bid, "rows": rows})
        manifest = write_segment(self.table.segments_dir, chunk[0], chunk[-1],
                                 self._concat(parts), seal_batches)
        # the staged segment becomes real only here: one fsync'd log line
        fault_point("table.seal.commit", path=self.table.path)
        self.table.append_commit_entry(_seal_entry(chunk[0], chunk[-1], manifest, seal_batches))
        global_registry().inc("table.segments_sealed")
        return 1

    # ----------------------------------------------------------- retire
    def retire(self) -> int:
        """Delete part files a CRC-intact committed segment supersedes;
        returns how many parts were retired."""
        if not self.policy.retire_parts:
            return 0
        retired = 0
        with span("table.retire"):
            batches, seals = self.table._committed_state()
            seg_of: dict[int, dict] = {}
            for s in sorted(seals, key=lambda s: s["_seq"]):
                for b in s["batches"]:
                    seg_of[int(b["batch_id"])] = s
            verified: dict[str, bool] = {}
            victims = []
            for bid, e in sorted(batches.items()):
                s = seg_of.get(bid)
                if s is None or e["_seq"] > s["_seq"]:
                    continue  # part-served (never sealed, or replayed)
                if not os.path.exists(os.path.join(self.table.path, e["file"])):
                    continue  # already gone
                if s["file"] not in verified:
                    verified[s["file"]] = self._verify_seal_bytes(s)
                if not verified[s["file"]]:
                    continue  # rotten segment: scrub first, keep parts
                victims.append(e["file"])
            if not victims:
                return 0
            # log-first: the retire entry commits the intent, then files
            # go; a kill mid-unlink just re-lists the survivors next pass
            fault_point("table.retire.commit", path=self.table.path)
            self.table.append_commit_entry({"retire": {"files": victims}})
            for fname in victims:
                try:
                    os.unlink(os.path.join(self.table.path, fname))
                except FileNotFoundError:
                    pass
                retired += 1
            fsync_dir(self.table.path)
            global_registry().inc("table.parts_retired", retired)
        return retired

    # ------------------------------------------------------------ scrub
    def scrub(self) -> dict:
        """Verify every committed segment's bytes; quarantine rot and
        rebuild from surviving parts.  Returns ``{"checked", "repaired",
        "quarantined"}``; raises :class:`SegmentCorruptError` when any
        segment could not be rebuilt (its parts are gone) — that history
        is unreadable and silence would be a wrong answer."""
        checked = repaired = 0
        lost: list[str] = []
        with span("table.scrub"):
            batches, seals = self.table._committed_state()
            for s in sorted(seals, key=lambda s: s["_seq"]):
                checked += 1
                if self._verify_seal_bytes(s):
                    continue
                fault_point("table.scrub.repair", path=self.table.path)
                quarantine_segment(self.table.segments_dir, s["file"])
                if self._rebuild(s, batches):
                    self.table.append_commit_entry(
                        {"scrub": {"file": s["file"], "action": "rebuild"}})
                    global_registry().inc("table.scrub_repairs")
                    repaired += 1
                else:
                    self.table.append_commit_entry(
                        {"scrub": {"file": s["file"], "action": "quarantine"}})
                    lost.append(s["file"])
        if lost:
            raise SegmentCorruptError(
                f"scrub quarantined {len(lost)} segment(s) with no"
                f" surviving parts to rebuild from: {', '.join(sorted(lost))}"
                " — the covered batches are unreadable"
            )
        return {"checked": checked, "repaired": repaired, "quarantined": len(lost)}

    def _rebuild(self, seal: dict, batches: dict[int, dict]) -> bool:
        """Re-stage a quarantined segment from its surviving parts and
        commit a fresh seal entry (later-wins supersedes the rotten one).
        False when any non-empty covered part is missing."""
        parts = []
        seal_batches = []
        for b in seal["batches"]:
            bid, rows = int(b["batch_id"]), int(b["rows"])
            seal_batches.append({"batch_id": bid, "rows": rows})
            if rows <= 0:
                continue
            e = batches.get(bid)
            p = os.path.join(self.table.path, e["file"] if e else f"part-{bid:010d}.parquet")
            if not os.path.exists(p):
                return False
            pyarrow_module()
            import pyarrow.parquet as pq

            parts.append(pq.read_table(p))
        first, last = int(seal["first"]), int(seal["last"])
        manifest = write_segment(self.table.segments_dir, first, last,
                                 self._concat(parts), seal_batches)
        fault_point("table.seal.commit", path=self.table.path)
        self.table.append_commit_entry(_seal_entry(first, last, manifest, seal_batches))
        return True

    # ------------------------------------------------------------- tick
    def tick(self, watermark=None) -> dict:
        """One lifecycle heartbeat: seal what went cold, retire what the
        new seals supersede.  (``scrub`` is a slower audit pass callers
        schedule separately.)"""
        sealed = self.seal(watermark)
        retired = self.retire()
        return {"sealed": sealed, "retired": retired}

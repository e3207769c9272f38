"""Streaming checkpoint: offsets WAL + commits + replay attempts, Spark-style
(the JAX package's ``streaming/checkpoint.py``; the same files and lines,
so a checkpoint written by either package resumes in the other).

Parity with ``option("checkpointLocation", …)`` at reference
``mllearnforhospitalnetwork.py:43,:114``.  An *offsets* entry (the files
a batch WILL process, plus watermark state) is written before the batch
runs, a *commits* entry after the sink accepts it.  On restart, an
offsets entry with no matching commit is replayed with exactly the same
inputs — the exactly-once recipe, with two JSON-line logs.

A third log, ``attempts.log``, records every *try* at a batch, so a
poison batch that kills the process on every replay is recognized across
restarts and quarantined — written to ``<ckpt>/quarantine/batch-<id>.json``
and committed as skipped — instead of wedging the stream forever.

The rung below batch quarantine (rows the data firewall rejects, under
``quarantine/rows/``) comes with the firewall, in slice 7 of the port.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

from ..io.model_io import fsync_dir
from .wal import append_line, read_lines

QUARANTINE_DIR = "quarantine"


@dataclass
class StreamCheckpoint:
    path: str

    def __post_init__(self) -> None:
        os.makedirs(self.path, exist_ok=True)
        self._offsets = os.path.join(self.path, "offsets.log")
        self._commits = os.path.join(self.path, "commits.log")
        self._attempts = os.path.join(self.path, "attempts.log")
        self._attempt_counts: dict[int, int] = {}
        # attempts live in attempts.log (replays) AND in offsets entries
        # carrying the piggybacked first attempt (begin_batch)
        for e in read_lines(self._attempts):
            bid = int(e["batch_id"])
            self._attempt_counts[bid] = self._attempt_counts.get(bid, 0) + 1
        for e in read_lines(self._offsets):
            if e.get("attempt"):
                bid = int(e["batch_id"])
                self._attempt_counts[bid] = self._attempt_counts.get(bid, 0) + 1

    # write-ahead intent -----------------------------------------------
    def write_offsets(self, batch_id: int, files: list[str], watermark_state: dict) -> None:
        append_line(
            self._offsets,
            {"batch_id": batch_id, "files": files, "watermark": watermark_state},
        )

    def begin_batch(
        self, batch_id: int, files: list[str], watermark_state: dict
    ) -> int:
        """Offsets intent + the batch's FIRST attempt as ONE durable
        append (one fsync instead of two on the per-batch path — every
        fresh batch needs both records before any side effect).  →
        attempts so far (1)."""
        append_line(
            self._offsets,
            {
                "batch_id": batch_id,
                "files": files,
                "watermark": watermark_state,
                "attempt": True,
            },
        )
        n = self._attempt_counts.get(batch_id, 0) + 1
        self._attempt_counts[batch_id] = n
        return n

    def write_commit(self, batch_id: int, quarantined: bool = False) -> None:
        entry: dict = {"batch_id": batch_id}
        if quarantined:
            entry["quarantined"] = True
        append_line(self._commits, entry)

    def record_attempt(self, batch_id: int) -> int:
        """Durably log one try at ``batch_id``; → total attempts so far
        (including crashes in previous incarnations of the process)."""
        append_line(self._attempts, {"batch_id": batch_id})
        n = self._attempt_counts.get(batch_id, 0) + 1
        self._attempt_counts[batch_id] = n
        return n

    def attempts(self, batch_id: int) -> int:
        return self._attempt_counts.get(batch_id, 0)

    # quarantine --------------------------------------------------------
    def quarantine(
        self,
        batch_id: int,
        files: list[str],
        attempts: int,
        error: str,
        sink_rows_visible: bool = False,
        reason: str = "poison",
    ) -> str:
        """Persist the poison batch's evidence (atomically — a quarantine
        record must never itself be torn) and return its path.

        ``reason``: ``"poison"`` (the batch itself kept failing) or
        ``"disk:budget"`` (the table's disk budget is spent — the data is
        fine to reprocess once space is freed)."""
        qdir = os.path.join(self.path, QUARANTINE_DIR)
        os.makedirs(qdir, exist_ok=True)
        p = os.path.join(qdir, f"batch-{batch_id:010d}.json")
        tmp = p + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "batch_id": batch_id,
                    "files": files,
                    "attempts": attempts,
                    "error": error,
                    "reason": reason,
                    "sink_rows_visible": sink_rows_visible,
                    "quarantined_at": time.time(),
                },
                f,
                indent=2,
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)
        # the evidence justifies the fsync'd commit-as-skipped line, so
        # its rename must be directory-durable too
        fsync_dir(qdir)
        return p

    def quarantined(self) -> list[dict]:
        """Every ``batch-*.json`` evidence record, in batch order; torn or
        unreadable files are skipped, never fatal."""
        qdir = os.path.join(self.path, QUARANTINE_DIR)
        if not os.path.isdir(qdir):
            return []
        out = []
        for name in sorted(os.listdir(qdir)):
            if not (name.startswith("batch-") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(qdir, name)) as f:
                    out.append(json.load(f))
            except (OSError, json.JSONDecodeError):
                continue
        return out

    def quarantine_count(self) -> int:
        return len(self.quarantined())

    # recovery ----------------------------------------------------------
    def recover(self) -> dict:
        """→ {next_batch_id, pending (offsets entry to replay or None),
        processed_files, watermark_state}"""
        offsets = {e["batch_id"]: e for e in read_lines(self._offsets)}
        commits = {e["batch_id"] for e in read_lines(self._commits)}
        processed: list[str] = []
        watermark_state: dict = {}
        pending = None
        for bid in sorted(offsets):
            e = offsets[bid]
            watermark_state = e.get("watermark", watermark_state)
            if bid in commits:
                processed.extend(e["files"])
            elif pending is None:
                pending = e
        next_id = (max(offsets) + 1) if offsets else 0
        return {
            "next_batch_id": next_id,
            "pending": pending,
            "processed_files": processed,
            "watermark_state": watermark_state,
        }

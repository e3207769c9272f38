"""Feedback loop: served predictions + later-arriving outcomes → ingest.

The closed-loop half of the continuous-learning story: what the model
*answered* and what *actually happened* are joined into feedback rows and
re-enter the SAME streaming ingest path as any hospital feed — firewall
validation, row quarantine, exactly-once commit into the unbounded table —
so the next retrain trains on lived outcomes, not just the original
snapshot.

Durability is the whole point (a feedback row lost to a crash is a
training row the model never gets back):

* every ``record_prediction`` / ``record_outcome`` is one fsync'd WAL
  append (``streaming/wal.py`` — torn tails repaired, corrupt lines
  skipped), so the pending spool survives any kill;
* a flush follows the offsets/commits discipline: a ``flush_intent``
  entry (the exact row ids) is durably appended FIRST, then the CSV is
  written atomically (tmp + rename) into the stream source's incoming
  directory, then ``flush_commit`` lands.  A kill at any byte boundary
  either replays the intent — same flush id, same rows, same filename,
  byte-identical file — or finds it committed.  The stream source sees
  each feedback file exactly once, and its own replay/quarantine ladder
  takes over from there.

After a flush commits, its rows are dropped from memory and the WAL is
compacted (atomic rewrite under a ``meta`` header that pins id/flush
numbering) — a long-lived server spools only the LIVE window, never its
whole serving history.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..core.schema import FLOAT, Schema
from ..core.table import Table
from ..io.csv import write_csv
from ..io.fit_checkpoint import fsync_dir as _fsync_dir
from ..streaming.wal import append_line, read_lines
from ..utils.faults import fault_point
from ..utils.logging import get_logger

log = get_logger("lifecycle")

#: feedback CSV columns appended after the feature columns
PREDICTION_COL = "prediction"
OUTCOME_COL = "outcome"




def feedback_schema(feature_names) -> Schema:
    """Schema of the feedback CSVs: the feature columns (float) plus the
    served prediction and the later-arriving outcome."""
    return Schema(
        [(n, FLOAT) for n in feature_names]
        + [(PREDICTION_COL, FLOAT), (OUTCOME_COL, FLOAT)]
    )


class FeedbackBuffer:
    """Durable spool joining served predictions with their outcomes and
    flushing the joined rows as CSV files into an ingest directory.

    One WAL (``feedback.log``) holds everything: prediction records,
    outcome records, and flush intent/commit markers.  Construction
    replays it, so the buffer's state — pending joins, unflushed rows,
    a half-done flush — survives process death exactly.
    """

    def __init__(self, root: str, feature_names, incoming_dir: str):
        self.root = root
        self.feature_names = tuple(feature_names)
        self.incoming_dir = incoming_dir
        os.makedirs(root, exist_ok=True)
        os.makedirs(incoming_dir, exist_ok=True)
        self._wal = os.path.join(root, "feedback.log")
        self._preds: dict[int, dict] = {}      # id -> {x, p}
        self._outcomes: dict[int, float] = {}  # id -> y
        self._flushed_ids: set[int] = set()
        self._next_id = 0
        self._next_flush = 0
        self._pending_intent: dict | None = None  # intent without commit
        self._replay()

    # ------------------------------------------------------------ replay
    def _replay(self) -> None:
        commits: set[int] = set()
        intents: dict[int, dict] = {}
        for e in read_lines(self._wal):
            kind = e.get("kind")
            if kind == "meta":
                # compaction header: flushed records are gone from the
                # WAL, but ids and flush numbering must never restart
                self._next_id = max(self._next_id, int(e["next_id"]))
                self._next_flush = max(self._next_flush, int(e["next_flush"]))
            elif kind == "pred":
                i = int(e["id"])
                self._preds[i] = {"x": e["x"], "p": float(e["p"])}
                self._next_id = max(self._next_id, i + 1)
            elif kind == "out":
                self._outcomes[int(e["id"])] = float(e["y"])
            elif kind == "flush_intent":
                fid = int(e["flush_id"])
                intents[fid] = e
                self._next_flush = max(self._next_flush, fid + 1)
            elif kind == "flush_commit":
                commits.add(int(e["flush_id"]))
        for fid in sorted(intents):
            self._flushed_ids.update(int(i) for i in intents[fid]["ids"])
            if fid not in commits:
                # crash between intent and commit: replay THIS flush
                # (same id, same rows) before accepting new work
                self._pending_intent = intents[fid]

    # ------------------------------------------------------------ record
    def record_prediction(self, x_row, prediction: float) -> int:
        """Durably spool one served prediction; returns its feedback id
        (the handle ``record_outcome`` joins on)."""
        x = [float(v) for v in np.asarray(x_row, dtype=np.float64).ravel()]
        if len(x) != len(self.feature_names):
            raise ValueError(
                f"feedback row has {len(x)} features, schema has "
                f"{len(self.feature_names)}"
            )
        fid = self._next_id
        self._next_id += 1
        append_line(
            self._wal, {"kind": "pred", "id": fid, "x": x, "p": float(prediction)}
        )
        self._preds[fid] = {"x": x, "p": float(prediction)}
        return fid

    def record_outcome(self, feedback_id: int, outcome: float) -> None:
        """Join the later-arriving ground truth onto a served prediction."""
        if feedback_id not in self._preds:
            raise KeyError(f"unknown feedback id {feedback_id}")
        append_line(
            self._wal, {"kind": "out", "id": int(feedback_id), "y": float(outcome)}
        )
        self._outcomes[int(feedback_id)] = float(outcome)

    # ----------------------------------------------------------- observe
    def joined_unflushed(self) -> list[int]:
        """Ids with both halves recorded and not yet claimed by a flush."""
        return sorted(
            i for i in self._preds
            if i in self._outcomes and i not in self._flushed_ids
        )

    def pending_outcomes(self) -> int:
        """Predictions still waiting for their outcome."""
        return sum(1 for i in self._preds if i not in self._outcomes)

    # ------------------------------------------------------------- flush
    def _file_for(self, flush_id: int) -> str:
        return os.path.join(
            self.incoming_dir, f"feedback-{flush_id:06d}.csv"
        )

    def flush(self) -> str | None:
        """Write the joined-but-unflushed rows as one CSV into the ingest
        directory (exactly-once; see module docstring).  Returns the file
        path, or None when nothing is ready."""
        from ..obs import trace as _trace

        with _trace.span("lifecycle.feedback"):
            return self._flush_inner()

    def _flush_inner(self) -> str | None:
        fault_point("lifecycle.feedback.flush", pending=len(self._preds))
        if self._pending_intent is not None:
            intent = self._pending_intent
            ids = [int(i) for i in intent["ids"]]
            fid = int(intent["flush_id"])
            log.warning(
                "replaying interrupted feedback flush",
                flush_id=fid, rows=len(ids),
            )
        else:
            ids = self.joined_unflushed()
            if not ids:
                return None
            fid = self._next_flush
            append_line(
                self._wal,
                {"kind": "flush_intent", "flush_id": fid, "ids": ids},
            )
            self._next_flush = fid + 1
            self._flushed_ids.update(ids)
        path = self._write_csv(fid, ids)
        append_line(self._wal, {"kind": "flush_commit", "flush_id": fid})
        self._pending_intent = None
        # flushed-and-committed rows are the stream's responsibility now:
        # drop them from memory and compact the WAL, else a long-lived
        # server retains every row it ever served and replays the whole
        # history on restart
        fault_point("lifecycle.feedback.compact", flush_id=fid)
        self._compact()
        return path

    def _compact(self) -> None:
        """Rewrite the WAL with only the LIVE records (pending predictions
        + their outcomes) under a meta header that pins id/flush
        numbering, then drop every flushed-and-committed row from memory.
        Records claimed by ANY committed flush are excluded — including
        ones a previous incarnation committed but never compacted (a kill
        in that window replays them into this WAL; writing them back as
        plain live records would shed their flushed status and double-
        flush them next restart).  Atomic (tmp + rename + dir fsync): a
        crash mid-compaction leaves the previous WAL, which replays to
        the same state — merely uncompacted."""
        tmp = self._wal + ".tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps({
                "kind": "meta",
                "next_id": self._next_id,
                "next_flush": self._next_flush,
            }) + "\n")
            for i in sorted(self._preds):
                if i in self._flushed_ids:
                    continue
                rec = self._preds[i]
                f.write(json.dumps(
                    {"kind": "pred", "id": i, "x": rec["x"], "p": rec["p"]}
                ) + "\n")
                if i in self._outcomes:
                    f.write(json.dumps(
                        {"kind": "out", "id": i, "y": self._outcomes[i]}
                    ) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._wal)
        _fsync_dir(self.root)
        # their CSVs are durable and their WAL history is gone: the
        # flushed rows no longer exist as far as this spool is concerned
        for i in list(self._flushed_ids):
            self._preds.pop(i, None)
            self._outcomes.pop(i, None)
        self._flushed_ids.clear()

    def _write_csv(self, flush_id: int, ids: list[int]) -> str:
        schema = feedback_schema(self.feature_names)
        d = len(self.feature_names)
        x = np.zeros((len(ids), d), dtype=np.float64)
        p = np.zeros(len(ids), dtype=np.float64)
        y = np.zeros(len(ids), dtype=np.float64)
        for r, i in enumerate(ids):
            rec = self._preds[i]
            x[r] = rec["x"]
            p[r] = rec["p"]
            y[r] = self._outcomes[i]
        cols = {n: x[:, j] for j, n in enumerate(self.feature_names)}
        cols[PREDICTION_COL] = p
        cols[OUTCOME_COL] = y
        table = Table.from_dict(cols, schema)
        path = self._file_for(flush_id)
        tmp = path + ".tmp"
        write_csv(table, tmp)
        with open(tmp, "rb+") as f:
            os.fsync(f.fileno())
        os.replace(tmp, path)  # the stream source never sees a torn file
        # without this, power loss after the commit marker lands could
        # still drop the rename — a "committed" flush whose file never
        # existed, rows lost with the WAL unable to know it
        _fsync_dir(self.incoming_dir)
        return path

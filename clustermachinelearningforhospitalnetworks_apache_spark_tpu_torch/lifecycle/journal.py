"""CRC-verified state-transition journal for the continuous-learning loop.

The lifecycle controller's durability spine: every state transition is one
JSON line ``{seq, cycle, state, info, crc32c}`` appended through the
streaming WAL helper (``streaming/wal.py``), so it inherits the fsync +
torn-tail-repair discipline the offsets/commits logs already chaos-prove —
a crash mid-append costs at most the entry being written, never committed
history.  On top of that, every entry carries a CRC32C of its canonical
payload: post-commit bit rot (the failure the WAL's parse-skip cannot
distinguish from a torn tail) is detected and the entry skipped rather
than trusted, with ``corrupt_skipped`` counting what was dropped.

Recovery = read the journal, take the last intact entry: the controller
is *defined* to be in that state.  Each transition's side effects are
idempotent (artifact saves displace-and-install, registry flips install a
journaled version, fit checkpoints resume), so replaying the step that was
interrupted converges to the same place — the exactly-once recipe of
``streaming/checkpoint.py`` applied to a state machine instead of a batch
stream.
"""

from __future__ import annotations

import json
import os

from ..io.integrity import crc32c_hex
from ..streaming.wal import append_line, read_lines
from ..utils.faults import fault_point


def _canonical(entry: dict) -> bytes:
    """The bytes the CRC covers: key-sorted, separator-pinned JSON of the
    entry WITHOUT its crc field — stable across json library defaults."""
    return json.dumps(
        entry, sort_keys=True, separators=(",", ":"), default=str
    ).encode()


class LifecycleJournal:
    """Append-only, CRC-verified record of lifecycle state transitions."""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        #: entries dropped by CRC/shape verification on the last read —
        #: surfaced in health so silent corruption is never silent
        self.corrupt_skipped = 0
        # single-writer, append-only: after the recovery read, the file's
        # contents are exactly what this instance appended, so entries()
        # serves from memory instead of re-reading + re-CRCing the whole
        # file on every transition (append was O(history) without this)
        self._cache: list[dict] | None = None

    # ------------------------------------------------------------ write
    def append(self, state: str, cycle: int, info: dict | None = None) -> dict:
        """Durably record one transition; returns the committed entry.

        The ``lifecycle.journal.append`` fault site fires BEFORE any byte
        lands (a kill here loses the whole entry — the previous state
        stays authoritative and the transition replays on resume); the
        underlying ``wal.append`` site can additionally tear the write at
        an exact byte offset.
        """
        entries = self.entries()
        entry = {
            "seq": entries[-1]["seq"] + 1 if entries else 0,
            "cycle": int(cycle),
            "state": str(state),
            "info": dict(info or {}),
        }
        fault_point(
            "lifecycle.journal.append",
            state=entry["state"], cycle=entry["cycle"], seq=entry["seq"],
            path=self.path,
        )
        crc = crc32c_hex(_canonical(entry))
        append_line(self.path, {**entry, "crc32c": crc})
        if self._cache is not None:
            self._cache.append(entry)
        return entry

    # ------------------------------------------------------------- read
    def entries(self) -> list[dict]:
        """All intact entries, seq order.  A CRC mismatch, missing field,
        or non-monotonic seq drops the entry (counted), never raises."""
        if self._cache is not None:
            return list(self._cache)
        out: list[dict] = []
        skipped = 0
        for raw in read_lines(self.path):
            if not isinstance(raw, dict):
                skipped += 1
                continue
            crc = raw.get("crc32c")
            body = {k: v for k, v in raw.items() if k != "crc32c"}
            try:
                ok = (
                    crc is not None
                    and crc32c_hex(_canonical(body)) == crc
                    and isinstance(body["seq"], int)
                    and isinstance(body["state"], str)
                )
            except (KeyError, TypeError):
                ok = False
            if not ok:
                skipped += 1
                continue
            if out and body["seq"] <= out[-1]["seq"]:
                skipped += 1
                continue
            out.append(body)
        self.corrupt_skipped = skipped
        self._cache = out
        return list(out)

    def last(self) -> dict | None:
        entries = self.entries()
        return entries[-1] if entries else None

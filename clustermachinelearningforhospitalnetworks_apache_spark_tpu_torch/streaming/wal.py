"""Shared JSON-lines write-ahead-log helpers.

One durability policy for both streaming logs (the checkpoint's
offsets/commits WAL and the unbounded table's commit log): appends are
fsync'd, a torn tail left by a crash mid-write is repaired by starting the
next append on a fresh line, and readers skip unparseable lines instead of
failing — so a crash at any byte boundary costs at most the uncommitted
entry that was being written, never previously-committed entries.

The torn-tail probe and the append share ONE descriptor (``"ab+"``:
writes always land at end-of-file, seeks only move the read head), so the
probe can never race a second opener, and the ``wal.append`` fault site
(:mod:`..utils.faults`) can tear the write at an exact byte offset — the
chaos tests drive every recovery branch below through it.
"""

from __future__ import annotations

import json
import os

from ..utils.faults import (
    InjectedCrash, enospc_error, enospc_point, fault_point, mangle_bytes,
    torn_point,
)


def append_line(path: str, obj: dict) -> None:
    """Durably append one JSON entry.

    If the file's last byte is not a newline (torn tail from a crash
    mid-append), a newline is written first so the new entry never merges
    into the torn one.
    """
    append_lines(path, [obj])


def append_lines(
    path: str, objs: list[dict], site: str | None = "wal.append"
) -> None:
    """Durably append a batch of JSON entries: same torn-tail repair as
    :func:`append_line`, ONE write + fsync for the whole batch — the
    amortized path the observability span log flushes through (a span
    per fsync would tax the hot paths it measures).

    ``site=None`` opts out of the ``wal.append`` fault hooks: the span
    log is an *observer* of the durability story, not part of it, so a
    chaos rule tearing the stream's offsets log must never be consumed
    by a tracer flush that happens to run first.
    """
    if site is not None:
        fault_point(site, path=path)
    payload = "".join(json.dumps(o) + "\n" for o in objs).encode()
    with open(path, "ab+") as f:
        # torn-tail probe on the same descriptor: append mode pins every
        # write to EOF regardless of the read position this seek sets
        f.seek(0, os.SEEK_END)
        if f.tell() > 0:
            f.seek(-1, os.SEEK_END)
            if f.read(1) != b"\n":
                payload = b"\n" + payload
        if site is not None:
            payload = mangle_bytes(site, payload, path=path)
            cut = torn_point(site, len(payload), path=path)
            if cut is not None:
                # injected torn write: persist exactly `cut` bytes, "die"
                f.write(payload[:cut])
                f.flush()
                os.fsync(f.fileno())
                raise InjectedCrash(
                    f"torn write at byte {cut} of {path}", site=site
                )
            fit = enospc_point(site, len(payload), path=path)
            if fit is not None:
                # injected disk-full: short write, then ENOSPC at the
                # fsync — the failure a real full disk produces.  The
                # partial line is exactly a torn tail, which the next
                # append's probe repairs; the error is an OSError, so
                # retry ladders treat it like any other IO failure.
                f.write(payload[:fit])
                f.flush()
                os.fsync(f.fileno())
                raise enospc_error(site, fit)
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())


def read_lines(path: str) -> list[dict]:
    """Read all parseable entries; skip torn/corrupt lines.

    With :func:`append_line`'s repair, corruption is confined to single
    lines, so skipping (not stopping at) a bad line cannot drop valid
    later entries.
    """
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out

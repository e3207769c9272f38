"""Streaming file source (the JAX package's ``streaming/source.py``).

The reference ingests with Spark's streaming file source — a directory
that accumulates CSV drops, re-listed every micro-batch
(``spark.readStream...csv(hdfs://.../incoming)``,
``mllearnforhospitalnetwork.py:74-80``).  Same contract: ``poll()`` lists
the directory (the native listing of ``io/native.py`` when its library is
available, else ``os.scandir``), diffs against the files already seen,
and returns the new batch in deterministic (mtime, name) order.  Each
file is read by the strict CSV reader (engine ``auto``) behind a per-file
retry and the ``source.read_file`` fault site.

Both listings are kept, as in the JAX package, because they are not the
same list: the native one decodes a file name that is not UTF-8 with
U+FFFD (so the path it returns names no file), where ``os.scandir``
keeps the name's bytes; and a file removed between the directory read
and its ``stat`` is skipped natively but raises under ``os.scandir``.
The port lists as the JAX package does on the same host.

With a data firewall (``quality/firewall.py``) the source reads in
salvage mode through :meth:`FileStreamSource.read_files_audited`: one bad
row rejects one row, and a drifted header is reconciled.
"""

from __future__ import annotations

import os
import random
import threading
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable

from ..core.schema import Schema
from ..core.table import Table
from ..io.csv import read_csv
from ..io.native import native_available, native_dir_list
from ..tune import knob
from ..utils.faults import fault_point
from ..utils.logging import get_logger
from ..utils.metrics import MetricsRegistry
from ..utils.retry import DEFAULT_IO_RETRY, RetryPolicy, call_with_retry

if TYPE_CHECKING:  # typing only
    from ..quality.firewall import DataFirewall

log = get_logger("streaming")


@dataclass
class FileStreamSource:
    path: str
    schema: Schema
    header: bool = True
    #: Spark's ``maxFilesPerTrigger``: cap how many new files one
    #: micro-batch takes (0 = unbounded).  None → the registry's
    #: ``stream.source.max_files_per_batch`` knob, resolved at each poll.
    max_files_per_batch: int | None = None
    #: per-file read retry (exponential backoff + jitter): a flaky
    #: hospital-source mount answers after a beat instead of failing the
    #: whole micro-batch; a persistent failure still surfaces (and the
    #: stream's replay/quarantine ladder takes over)
    retry: RetryPolicy = DEFAULT_IO_RETRY
    retries: int = 0
    metrics: MetricsRegistry | None = None
    #: optional data-quality firewall: :meth:`read_files_audited` reads in
    #: salvage mode through it; without one, reads stay strict
    firewall: "DataFirewall | None" = None
    _seen: set[str] = field(default_factory=set)
    _seen_gen: int = field(default=0, repr=False)
    # guards _seen: the pipelined stream's worker thread snapshots it
    # while the commit thread marks files committed
    _seen_lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    # entropy-seeded on purpose: a fleet of sources must not retry-jitter
    # in lockstep; jitter affects timing only, never data
    _rng: random.Random = field(default_factory=random.Random, repr=False)

    def list_files(self) -> list[str]:
        if not os.path.isdir(self.path):
            return []
        if native_available():
            entries = [
                (mtime_ns, name, os.path.join(self.path, name))
                for mtime_ns, _size, name in native_dir_list(self.path, ".csv")
            ]
        else:
            entries = []
            with os.scandir(self.path) as it:
                for e in it:
                    if e.is_file() and e.name.endswith(".csv"):
                        entries.append((e.stat().st_mtime_ns, e.name, e.path))
        entries.sort()
        return [p for _, _, p in entries]

    def poll(self) -> list[str]:
        """New files since the last poll (does not mark them processed —
        call :meth:`commit_files` after the batch commits, so a crash
        between poll and commit replays the same files), capped at the
        per-batch file cap when that is positive."""
        new = [f for f in self.list_files() if f not in self._seen]
        cap = self.files_cap()
        return new[:cap] if cap > 0 else new

    def files_cap(self) -> int:
        """The resolved per-batch file cap (0 = unbounded)."""
        if self.max_files_per_batch is None:
            return int(knob("stream.source.max_files_per_batch"))
        return self.max_files_per_batch

    def commit_files(self, files: list[str]) -> None:
        with self._seen_lock:
            self._seen.update(files)
            self._seen_gen += 1

    def restore(self, files: list[str]) -> None:
        """Re-mark files as seen when resuming from a checkpoint."""
        self.commit_files(files)

    def seen_generation(self) -> int:
        """Bumped on every ``_seen`` mutation — lets a concurrent reader
        cache :meth:`seen_snapshot` instead of copying the (ever-growing)
        committed-file set on every poll."""
        with self._seen_lock:
            return self._seen_gen

    def seen_snapshot(self) -> frozenset:
        """Consistent copy of the committed-file set — iterating ``_seen``
        directly from another thread races ``commit_files`` (a set resize
        mid-iteration raises RuntimeError)."""
        with self._seen_lock:
            return frozenset(self._seen)

    def _retried(self, f: str, read: Callable):
        """``read(f)`` behind the per-file retry and the
        ``source.read_file`` fault site."""

        def attempt():
            fault_point("source.read_file", file=f)
            return read(f)

        def on_retry(n: int, exc: Exception, delay: float) -> None:
            self.retries += 1
            if self.metrics is not None:
                self.metrics.inc("stream.retries")
            log.warning(
                "source read retry", file=os.path.basename(f), attempt=n,
                delay_s=round(delay, 3), error=repr(exc),
            )

        return call_with_retry(attempt, self.retry, rng=self._rng, on_retry=on_retry)

    def _read_one(self, f: str) -> Table:
        return self._retried(f, lambda p: read_csv(p, self.schema, header=self.header))

    def read_files(self, files: list[str]) -> Table:
        if not files:
            return Table.empty(self.schema)
        return Table.concat([self._read_one(f) for f in files])

    def _ingest_one(self, f: str):
        """Firewalled read of one file → ``quality.FirewallResult``."""
        return self._retried(f, lambda p: self.firewall.ingest_file(p, header=self.header))

    def read_files_audited(self, files: list[str]) -> tuple[Table, list[dict], list]:
        """Salvage-mode batch read through the firewall: → (accepted
        table, per-row reject records, schema-drift events).  Without a
        firewall it is the strict read (no rejects possible)."""
        if not files:
            return Table.empty(self.schema), [], []
        if self.firewall is None:
            return self.read_files(files), [], []
        results = [self._ingest_one(f) for f in files]
        return (
            Table.concat([r.table for r in results]),
            [rej for r in results for rej in r.rejects],
            [ev for r in results for ev in r.drift_events],
        )

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

The data firewall's salvage reads come with slice 7 of the port.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass, field

from ..core.schema import Schema
from ..core.table import Table
from ..io.csv import read_csv
from ..io.native import native_available, native_dir_list
from ..utils.faults import fault_point
from ..utils.logging import get_logger
from ..utils.metrics import MetricsRegistry
from ..utils.retry import DEFAULT_IO_RETRY, RetryPolicy, call_with_retry

log = get_logger("streaming")

@dataclass
class FileStreamSource:
    path: str
    schema: Schema
    header: bool = True
    #: Spark's ``maxFilesPerTrigger``: cap how many new files one
    #: micro-batch takes (0 = unbounded, the JAX package's knob default;
    #: the knob registry that may set it comes with slice 7)
    max_files_per_batch: int = 0
    #: per-file read retry (exponential backoff + jitter): a flaky
    #: hospital-source mount answers after a beat instead of failing the
    #: whole micro-batch; a persistent failure still surfaces (and the
    #: stream's replay/quarantine ladder takes over)
    retry: RetryPolicy = DEFAULT_IO_RETRY
    retries: int = 0
    metrics: MetricsRegistry | None = None
    _seen: set[str] = field(default_factory=set)
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
        cap = self.max_files_per_batch
        return new[:cap] if cap > 0 else new

    def commit_files(self, files: list[str]) -> None:
        self._seen.update(files)

    def restore(self, files: list[str]) -> None:
        """Re-mark files as seen when resuming from a checkpoint."""
        self.commit_files(files)

    def _read_one(self, f: str) -> Table:
        def attempt() -> Table:
            fault_point("source.read_file", file=f)
            return read_csv(f, self.schema, header=self.header)

        def on_retry(n: int, exc: Exception, delay: float) -> None:
            self.retries += 1
            if self.metrics is not None:
                self.metrics.inc("stream.retries")
            log.warning(
                "source read retry", file=os.path.basename(f), attempt=n,
                delay_s=round(delay, 3), error=repr(exc),
            )

        return call_with_retry(attempt, self.retry, rng=self._rng, on_retry=on_retry)

    def read_files(self, files: list[str]) -> Table:
        if not files:
            return Table.empty(self.schema)
        return Table.concat([self._read_one(f) for f in files])

"""DataFirewall: the composed data-quality boundary for ingest.

One object, threaded through the whole path (``streaming/source.py`` →
``streaming/microbatch.py`` → training → ``serve/``), that turns every
raw per-hospital CSV into

    (accepted rows, per-row rejects with reasons, schema-drift events)

without ever failing a file or a batch for data reasons.  Composition,
in pass order:

1. **parse** — clean files (header matches the schema exactly, no data
   faults planned) take the strict engine chain (native C++ scan when
   built); anything else drops to the salvage parser
   (``io/csv.py::read_csv_salvage``), which reconciles drifted headers
   and rejects malformed rows individually;
2. **suspect rescan** — a strict fast-path read maps garbage numerics to
   NaN silently; rows that came back with nulls are re-read from the raw
   text and every non-empty-but-unparseable field becomes a proper
   ``parse:<col>`` reject.  Clean files have zero suspects and pay
   nothing — this is what keeps the firewall cheap on clean drops while
   still quarantining *exactly* the bad rows;
3. **validate** — the vectorized :class:`~.validators.RowValidator`
   (ranges, domains, non-null, monotone) splits the typed table;
4. **observe** — accepted feature rows feed the optional
   :class:`~.drift.DriftMonitor` so ingest-side distribution drift is
   scored continuously against the training reference.

The firewall keeps aggregate counters (rows in/accepted/rejected, reason
histogram, drift events) so one ``snapshot()`` describes the data plane
the way ``InferenceServer.health()`` describes the serving plane.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Mapping

import numpy as np

from ..core.schema import Schema, STRING
from ..core.table import Table
from ..io.csv import (
    CSV_TEXT_SITE,
    RowReject,
    SalvageResult,
    parses_as,
    read_csv,
    read_csv_salvage,
)
from ..utils import faults
from ..utils.logging import get_logger
from .drift import DriftMonitor
from .reconcile import DriftEvent
from .validators import ConstraintSet, RowValidator, ValidationResult

log = get_logger("quality")


@dataclass
class FirewallResult:
    """What one guarded ingest produced."""

    table: Table                       # accepted rows only
    rejects: list[dict] = field(default_factory=list)
    drift_events: list[DriftEvent] = field(default_factory=list)
    n_input: int = 0
    histogram: dict[str, int] = field(default_factory=dict)

    @property
    def n_rejected(self) -> int:
        return len(self.rejects)


class DataFirewall:
    """Schema + constraints + (optional) drift reference, compiled once."""

    def __init__(
        self,
        schema: Schema,
        constraints: ConstraintSet | None = None,
        aliases: Mapping[str, str] | None = None,
        monitor: DriftMonitor | None = None,
        rescan_nulls: bool = True,
    ):
        """``rescan_nulls``: after a strict fast-path read, re-read the
        rows that parsed to null from the raw text to classify garbage
        (reject, ``parse:<col>``) vs genuinely empty (accept as NaN).
        The rescan pays one extra O(file) text pass whenever ANY row has
        a null — a fleet with heavy *legitimate* missingness can turn it
        off and accept that fast-path garbage degrades to NaN (the
        salvage path, taken for drifted/faulted files, still classifies
        exactly).

        Counters (``rows_in`` etc.) and the drift monitor are updated
        per ingest call; a stream *replay* re-ingests the same files, so
        treat them as attempt-scoped observability, not exact totals —
        the stream's own metrics and quarantine files are replay-exact.
        """
        self.schema = schema
        self.validator = RowValidator(schema, constraints)
        self.aliases = dict(aliases or {})
        self.monitor = monitor
        self.rescan_nulls = rescan_nulls
        # header reconciliation amortized across batches: each distinct
        # header layout (per hospital, typically one) is reconciled ONCE
        # and every later drop with the same header reuses the mapping
        # (events re-bound to the new file's context by the salvage parser)
        self._mapping_cache: dict[tuple, object] = {}
        # aggregate counters (host-side, one writer at a time per stream)
        self.rows_in = 0
        self.rows_accepted = 0
        self.rows_rejected = 0
        self.histogram: dict[str, int] = {}
        self.drift_event_count = 0
        #: cumulative wall seconds split parse vs validate — the firewall
        #: is one pipeline stage from the outside, but its internal split
        #: is what a streaming benchmark reports per stage
        self.stage_seconds = {"parse": 0.0, "validate": 0.0}

    # ------------------------------------------------------------ ingest
    def ingest_file(self, path: str, header: bool = True) -> FirewallResult:
        """Parse + rescan + validate one file (see module docstring)."""
        t0 = time.perf_counter()
        parse_rejects: list[RowReject] = []
        events: list[DriftEvent] = []
        table = None
        n_input = 0
        if header and not faults.data_rules_active(CSV_TEXT_SITE):
            if self._header_matches(path):
                try:
                    table = read_csv(path, self.schema, header=True)
                    n_input = len(table)
                except Exception as e:  # noqa: BLE001 — strict engines
                    # failing the file is exactly what salvage exists for
                    log.warning(
                        "strict parse failed; salvaging",
                        file=path, error=repr(e),
                    )
                    table = None
        if table is None:
            sr: SalvageResult = read_csv_salvage(
                path, self.schema, header=header, aliases=self.aliases,
                mapping_cache=self._mapping_cache,
            )
            table, parse_rejects = sr.table, sr.rejects
            events = list(sr.drift_events)
            n_input = sr.n_input_rows
        else:
            table, rescan_rejects = self._rescan_suspects(path, table)
            parse_rejects = rescan_rejects
        self.stage_seconds["parse"] += time.perf_counter() - t0
        return self._finish(table, parse_rejects, events, n_input, path)

    def ingest_table(self, table: Table, context: str = "") -> FirewallResult:
        """Validate an already-typed table (e.g. an Arrow hand-off)."""
        return self._finish(table, [], [], len(table), context)

    # ------------------------------------------------------------ helpers
    def _header_matches(self, path: str) -> bool:
        try:
            with open(path) as fh:
                first = fh.readline()
        except OSError:
            return False
        return [s.strip() for s in first.rstrip("\n").split(",")] == (
            self.schema.names
        )

    def _rescan_suspects(
        self, path: str, table: Table
    ) -> tuple[Table, list[RowReject]]:
        """Classify fast-path nulls: re-read only the rows that parsed to
        null and reject those whose raw field was present but garbage.
        Only the suspect lines are split/inspected; the file pass itself
        is C-level line iteration (see ``rescan_nulls`` for the cost
        model and the opt-out)."""
        if not self.rescan_nulls:
            return table, []
        null_cols = []
        null_by_col = {}
        for f in self.schema:
            if f.dtype == STRING:
                continue
            v = table.columns[f.name]
            nulls = (
                np.isnat(v) if v.dtype.kind == "M"
                else np.isnan(v.astype(np.float64))
            )
            if nulls.any():
                null_cols.append(f.name)
                null_by_col[f.name] = nulls
        if not null_cols:
            return table, []
        suspect = np.zeros(len(table), dtype=bool)
        for nulls in null_by_col.values():
            suspect |= nulls
        # one lazy pass: keep ONLY the suspect lines (with their PHYSICAL
        # 1-based line numbers — blank lines counted), count the rest
        wanted = set(np.flatnonzero(suspect).tolist())
        suspect_lines: dict[int, tuple[int, str]] = {}
        n_data = 0
        try:
            with open(path) as fh:
                first = True
                for phys, ln in enumerate(fh, start=1):
                    if not ln.strip():
                        continue
                    if first:  # fast path implies a matching header
                        first = False
                        continue
                    if n_data in wanted:
                        suspect_lines[n_data] = (phys, ln.rstrip("\n"))
                    n_data += 1
        except OSError:
            return table, []
        if n_data != len(table):
            return table, []  # engine dropped/merged rows: cannot align
        col_pos = {n: j for j, n in enumerate(self.schema.names)}
        rejects: list[RowReject] = []
        keep = np.ones(len(table), dtype=bool)
        for i in sorted(suspect_lines):
            line_no, line = suspect_lines[i]
            parts = line.split(",")
            reasons = []
            if len(parts) != len(self.schema.names):
                # a ragged line the strict engine padded with nulls is a
                # field-count reject, not a row of genuine missing values
                reasons.append("field_count")
            else:
                for name in null_cols:
                    if not null_by_col[name][i]:
                        continue
                    j = col_pos[name]
                    raw = parts[j].strip()
                    if raw and not parses_as(raw, self.schema.field(name).dtype):
                        reasons.append(f"parse:{name}")
            if reasons:
                keep[i] = False
                rejects.append(
                    RowReject(line_no, line, tuple(reasons))
                )
        if rejects:
            table = table.mask(keep)
        return table, rejects

    def _finish(
        self,
        table: Table,
        parse_rejects: list[RowReject],
        events: list[DriftEvent],
        n_input: int,
        context: str,
    ) -> FirewallResult:
        t0 = time.perf_counter()
        vr: ValidationResult = self.validator.validate(table)
        self.stage_seconds["validate"] += time.perf_counter() - t0
        rejects = [
            {"context": context, **r.to_dict()} for r in parse_rejects
        ] + vr.reject_records(context)
        histogram: dict[str, int] = dict(vr.histogram)
        for r in parse_rejects:
            for reason in r.reasons:
                histogram[reason] = histogram.get(reason, 0) + 1
        # aggregate counters
        self.rows_in += n_input
        self.rows_accepted += len(vr.accepted)
        self.rows_rejected += len(rejects)
        for k, v in histogram.items():
            self.histogram[k] = self.histogram.get(k, 0) + v
        self.drift_event_count += len(events)
        if self.monitor is not None and len(vr.accepted):
            names = self.monitor.reference.names
            if all(n in self.schema for n in names):
                self.monitor.observe(
                    vr.accepted.numeric_matrix(list(names))
                )
        if rejects:
            log.warning(
                "firewall rejected rows",
                context=context, rejected=len(rejects),
                reasons=sorted(histogram),
            )
        for ev in events:
            log.warning("schema drift", **ev.to_dict())
        return FirewallResult(
            table=vr.accepted,
            rejects=rejects,
            drift_events=events,
            n_input=n_input,
            histogram=histogram,
        )

    # ------------------------------------------------------------ observe
    def snapshot(self) -> dict:
        out = {
            "rows_in": self.rows_in,
            "rows_accepted": self.rows_accepted,
            "rows_rejected": self.rows_rejected,
            "reject_histogram": dict(sorted(self.histogram.items())),
            "drift_events": self.drift_event_count,
        }
        if self.monitor is not None:
            out["drift"] = self.monitor.snapshot()
        return out

"""Strict CSV ingest and the table writer (the JAX package's ``io/csv.py``
``read_csv`` / ``read_csv_dir`` / ``write_csv``).

Three engines parse a header CSV into the schema's types, each as the
JAX package's engine of the same name does, faults included:

* ``native`` — the C++ scan of ``native/csv_scan.cpp`` (``io/native.py``):
  RFC-4180 quoting, NaN for an empty or unparsable number (hex such as
  ``0x10`` parses, ``1_000`` does not), NaT for an empty timestamp;
* ``arrow`` — ``pyarrow.csv`` with type inference: integer columns stay
  int64, a ``string`` column of digits comes back as integers, and short
  rows, long rows and bad numbers raise;
* ``numpy`` — a split on commas and Python's ``float`` per cell.

``auto`` takes them in the JAX package's order: native when its library
is available (an error on a file falls through to the next engine under
``auto`` only), then Arrow (only a missing ``pyarrow`` falls through),
then numpy.  :func:`engine_counts` says how many files each engine read.

The **salvage** mode (:func:`read_csv_salvage`) is the data firewall's
parser: it reads by *header name* (reconciling drifted layouts through
``quality/reconcile.py``), converts column-at-a-time with a bulk numpy
cast first and a per-cell fallback only when the bulk cast fails, and
returns ``(table, rejects, drift_events)`` — one malformed field rejects
one ROW with a machine-readable reason (``"parse:<col>"`` /
``"field_count"``), never the file.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from ..core.schema import STRING, TIMESTAMP, Schema
from ..core.table import Table
from ..utils.faults import corrupt_data
from .native import native_available, native_read_table

ENGINES = ("auto", "native", "arrow", "numpy")

_COUNT_LOCK = threading.Lock()
_ENGINE_FILES = {"native": 0, "arrow": 0, "numpy": 0}


def engine_counts() -> dict[str, int]:
    """Files read by each engine since the last :func:`reset_engine_counts`."""
    with _COUNT_LOCK:
        return dict(_ENGINE_FILES)


def reset_engine_counts() -> None:
    with _COUNT_LOCK:
        for k in _ENGINE_FILES:
            _ENGINE_FILES[k] = 0


def _counted(engine: str, table: Table) -> Table:
    with _COUNT_LOCK:
        _ENGINE_FILES[engine] += 1
    return table


def read_csv(path: str, schema: Schema, header: bool = True, engine: str = "auto") -> Table:
    """Read one CSV file into a Table with the given schema.

    engine: "auto" (native → arrow → numpy), "native", "arrow", "numpy"."""
    if engine not in ENGINES:
        raise ValueError(f"unknown CSV engine {engine!r}; one of {ENGINES}")
    if engine in ("auto", "native") and native_available():
        try:
            return _counted("native", _read_native(path, schema, header))
        except Exception:
            if engine == "native":
                raise
    if engine in ("auto", "arrow"):
        try:
            return _counted("arrow", _read_arrow(path, schema, header))
        except ImportError:
            if engine == "arrow":
                raise
    return _counted("numpy", _read_numpy(path, schema, header))


def read_csv_dir(path: str, schema: Schema, header: bool = True) -> Table:
    """Read every ``*.csv`` under a directory, in name order."""
    files = sorted(
        os.path.join(path, f) for f in os.listdir(path) if f.endswith(".csv")
    )
    if not files:
        return Table.empty(schema)
    return Table.concat([read_csv(f, schema, header) for f in files])


def _read_native(path: str, schema: Schema, header: bool) -> Table:
    """The C++ scan: float64 / int64-ns / string column buffers straight
    from the file (``io/native.py``)."""
    kinds = [
        2 if f.dtype == STRING else (1 if f.dtype == TIMESTAMP else 0) for f in schema
    ]
    num, ts, strs, _rows = native_read_table(path, kinds, header)
    data = {}
    ji = jt = js = 0
    for f, kind in zip(schema, kinds):
        if kind == 2:
            data[f.name] = strs[js]
            js += 1
        elif kind == 1:
            # the scan's int64-min sentinel views directly as numpy NaT
            data[f.name] = ts[:, jt].copy().view("datetime64[ns]")
            jt += 1
        else:
            data[f.name] = num[:, ji].copy()
            ji += 1
    return Table.from_dict(data, schema)


def _read_arrow(path: str, schema: Schema, header: bool) -> Table:
    import pyarrow.csv as pacsv

    read_opts = pacsv.ReadOptions(
        column_names=None if header else schema.names, autogenerate_column_names=False
    )
    tbl = pacsv.read_csv(path, read_options=read_opts)
    data = {}
    for f in schema:
        data[f.name] = tbl.column(f.name).to_numpy(zero_copy_only=False)
    return Table.from_dict(data, schema)


def _read_numpy(path: str, schema: Schema, header: bool) -> Table:
    with open(path) as fh:
        lines = [ln.rstrip("\n") for ln in fh if ln.strip()]
    if header and lines:
        lines = lines[1:]
    cols: list[list[str]] = [[] for _ in schema]
    for ln in lines:
        parts = ln.split(",")
        for i in range(len(schema)):
            cols[i].append(parts[i] if i < len(parts) else "")
    return _from_string_columns([np.array(c, dtype=object) for c in cols], schema)


def _from_string_columns(cols: Sequence[np.ndarray], schema: Schema) -> Table:
    data = {}
    for f, raw in zip(schema, cols):
        if f.dtype == STRING:
            data[f.name] = raw
        elif f.dtype == TIMESTAMP:
            data[f.name] = np.array(
                [np.datetime64(v.replace(" ", "T")) if v else np.datetime64("NaT") for v in raw],
                dtype="datetime64[ns]",
            )
        else:
            out = np.empty(len(raw), dtype=np.float64)
            for i, v in enumerate(raw):
                try:
                    out[i] = float(v)
                except (TypeError, ValueError):
                    out[i] = np.nan
            data[f.name] = out
    return Table.from_dict(data, schema)


# --------------------------------------------------------------- salvage

#: fault site where data-corruption rules rewrite the CSV text in flight
CSV_TEXT_SITE = "ingest.csv_text"

#: cap on cached header→mapping entries: a fleet has a handful of real
#: layouts, but corrupted/garbage headers are unique per file — an
#: unbounded cache would grow for the life of a 24/7 stream.  Beyond the
#: cap new layouts just reconcile uncached (correctness unchanged).
MAPPING_CACHE_MAX = 64


@dataclass(frozen=True)
class RowReject:
    """One row the salvage parser refused, with evidence."""

    line_no: int          # 1-based line number in the source file
    raw: str              # the raw CSV line
    reasons: tuple[str, ...]

    def to_dict(self) -> dict:
        return {
            "line_no": self.line_no,
            "raw": self.raw,
            "reasons": list(self.reasons),
        }


@dataclass
class SalvageResult:
    """(table, per-row rejects, schema-drift events) from one salvage read."""

    table: Table
    rejects: list[RowReject] = field(default_factory=list)
    drift_events: list = field(default_factory=list)
    n_input_rows: int = 0


def read_csv_salvage(
    path: str,
    schema: Schema,
    header: bool = True,
    aliases: dict[str, str] | None = None,
    mapping_cache: dict | None = None,
) -> SalvageResult:
    """Salvage-mode read: malformed fields reject rows (with reasons),
    drifted headers are reconciled (with events) — the file never fails.

    The raw text passes through the ``ingest.csv_text`` fault site first,
    so chaos plans can mangle/shuffle/rescale it deterministically.
    ``mapping_cache`` (header-tuple → ColumnMapping) lets a long-running
    caller (the firewall) reconcile each hospital's header layout once
    and reuse it for every later drop with the same header."""
    with open(path) as fh:
        text = fh.read()
    text = corrupt_data(CSV_TEXT_SITE, text, file=path)
    return salvage_from_text(
        text, schema, header=header, aliases=aliases,
        context=os.path.basename(path), mapping_cache=mapping_cache,
    )


def read_csv_dir_salvage(
    path: str,
    schema: Schema,
    header: bool = True,
    aliases: dict[str, str] | None = None,
) -> SalvageResult:
    """Salvage analogue of :func:`read_csv_dir`: every ``*.csv`` under the
    directory, rejects and drift events aggregated across files."""
    files = sorted(
        os.path.join(path, f) for f in os.listdir(path) if f.endswith(".csv")
    )
    if not files:
        return SalvageResult(Table.empty(schema))
    parts = [read_csv_salvage(f, schema, header, aliases) for f in files]
    return SalvageResult(
        table=Table.concat([p.table for p in parts]),
        rejects=[r for p in parts for r in p.rejects],
        drift_events=[e for p in parts for e in p.drift_events],
        n_input_rows=sum(p.n_input_rows for p in parts),
    )


def parses_as(raw: str, dtype: str) -> bool:
    """Would this raw CSV field convert under the salvage rules for this
    schema dtype?  THE definition both classification paths share — the
    salvage parser's per-cell fallbacks and the firewall's fast-path
    rescan must agree on what counts as garbage, or the same dirty file
    would quarantine different rows depending on the parse path taken."""
    if dtype == STRING:
        return True
    if dtype == TIMESTAMP:
        try:
            np.datetime64(raw.replace(" ", "T"))
            return True
        except ValueError:
            return False
    try:
        float(raw)
        return True
    except (TypeError, ValueError):
        return False


def salvage_from_text(
    text: str,
    schema: Schema,
    header: bool = True,
    aliases: dict[str, str] | None = None,
    context: str = "",
    mapping_cache: dict | None = None,
) -> SalvageResult:
    """Parse CSV text in salvage mode (see module docstring)."""
    # lazy: quality.reconcile sits above io in the import graph
    from dataclasses import replace

    from ..quality.reconcile import reconcile_columns

    # keep PHYSICAL 1-based line numbers (blank lines skipped but counted)
    # so quarantine evidence points at the actual line in the file
    numbered = [
        (i + 1, ln) for i, ln in enumerate(text.split("\n")) if ln.strip()
    ]
    if header:
        if not numbered:
            return SalvageResult(Table.empty(schema))
        source_names = [s.strip() for s in numbered[0][1].split(",")]
        data_lines = numbered[1:]
        cache_key = tuple(source_names)
        mapping = (
            mapping_cache.get(cache_key) if mapping_cache is not None else None
        )
        if mapping is None:
            mapping = reconcile_columns(source_names, schema, aliases, context)
            if mapping_cache is not None and len(mapping_cache) < MAPPING_CACHE_MAX:
                mapping_cache[cache_key] = mapping
        # events are per-FILE evidence: rebind the (possibly cached)
        # mapping's events to this file's context so reuse across drops
        # from the same hospital never mislabels the evidence
        events = [
            e if e.context == context else replace(e, context=context)
            for e in mapping.events
        ]
        indices = mapping.indices
    else:
        source_names = schema.names
        data_lines = numbered
        events = []
        indices = {n: j for j, n in enumerate(schema.names)}

    n_src = len(source_names)
    rejects: list[RowReject] = []
    rows: list[list[str]] = []
    row_lines: list[int] = []
    for line_no, ln in data_lines:
        parts = ln.split(",")
        if len(parts) != n_src:
            rejects.append(RowReject(line_no, ln, ("field_count",)))
        else:
            rows.append(parts)
            row_lines.append(line_no)

    m = len(rows)
    raw_cols: dict[str, np.ndarray] = {}
    for t, idx in indices.items():
        if idx is None:
            raw_cols[t] = np.full(m, "", dtype=object)
        else:
            raw_cols[t] = np.array([r[idx].strip() for r in rows], dtype=object)

    bad: dict[int, list[str]] = {}
    data: dict[str, np.ndarray] = {}
    for f in schema:
        raw = raw_cols[f.name]
        if f.dtype == STRING:
            data[f.name] = np.array(
                [v if v != "" else None for v in raw], dtype=object
            )
        elif f.dtype == TIMESTAMP:
            out = np.empty(m, dtype="datetime64[ns]")
            for i, v in enumerate(raw):
                if not v:
                    out[i] = np.datetime64("NaT")
                    continue
                try:
                    out[i] = np.datetime64(v.replace(" ", "T"))
                except ValueError:
                    out[i] = np.datetime64("NaT")
                    bad.setdefault(i, []).append(f"parse:{f.name}")
            data[f.name] = out
        else:  # numeric: bulk C-level cast first, per-cell only on failure
            subst = np.where(raw == "", "nan", raw) if m else raw
            try:
                data[f.name] = subst.astype(np.float64)
            except (TypeError, ValueError):
                out = np.empty(m, dtype=np.float64)
                for i, v in enumerate(subst):
                    try:
                        out[i] = float(v)
                    except (TypeError, ValueError):
                        out[i] = np.nan
                        bad.setdefault(i, []).append(f"parse:{f.name}")
                data[f.name] = out

    if bad:
        keep = np.ones(m, dtype=bool)
        for i in sorted(bad):
            keep[i] = False
            rejects.append(
                RowReject(row_lines[i], ",".join(rows[i]), tuple(bad[i]))
            )
        data = {k: v[keep] for k, v in data.items()}
    rejects.sort(key=lambda r: r.line_no)
    if m == 0:
        table = Table.empty(schema)
        # preserve schema dtypes for the 0-row case (from_dict would too,
        # but empty object arrays trip the timestamp cast)
    else:
        table = Table.from_dict(data, schema)
    return SalvageResult(
        table=table,
        rejects=rejects,
        drift_events=events,
        n_input_rows=len(data_lines),
    )


def write_csv(table: Table, path: str, header: bool = True) -> None:
    """One line per row, fields joined by commas, each value through
    ``str()`` (floats round-trip exactly; timestamps as
    ``YYYY-MM-DD HH:MM:SS.fffffffff``).  No durability of its own: a
    caller that needs one stages and renames."""
    with open(path, "w") as f:
        if header:
            f.write(",".join(table.schema.names) + "\n")
        cols = [table.columns[n] for n in table.schema.names]
        for i in range(len(table)):
            row = []
            for c in cols:
                v = c[i]
                if isinstance(v, np.datetime64):
                    row.append(str(v).replace("T", " "))
                else:
                    row.append(str(v))
            f.write(",".join(row) + "\n")

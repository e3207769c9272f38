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
The salvage parser belongs to a later slice of the port.
"""

from __future__ import annotations

import os
import threading
from typing import Sequence

import numpy as np

from ..core.schema import STRING, TIMESTAMP, Schema
from ..core.table import Table
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

"""Strict CSV ingest on the numpy engine, and the table writer (the JAX
package's ``io/csv.py`` ``read_csv`` / ``read_csv_dir`` / ``write_csv``).

Every field of a header CSV is parsed into the schema's type: strings
stay objects, timestamps become ``datetime64[ns]`` (NaT when empty),
numeric fields float64 (NaN when empty or unparsable, dropped later by
``na_drop``).  The JAX package's native and Arrow engines and its salvage
parser belong to a later slice of the port.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from ..core.schema import STRING, TIMESTAMP, Schema
from ..core.table import Table

ENGINES = ("auto", "numpy")


def read_csv(path: str, schema: Schema, header: bool = True, engine: str = "auto") -> Table:
    """Read one CSV file into a Table with the given schema.  Only the
    numpy engine is ported ("auto" means it here)."""
    if engine not in ENGINES:
        raise NotImplementedError(
            f"CSV engine {engine!r} is not ported yet (slice 3 of the port); "
            "use engine='numpy'"
        )
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


def read_csv_dir(path: str, schema: Schema, header: bool = True) -> Table:
    """Read every ``*.csv`` under a directory, in name order."""
    files = sorted(
        os.path.join(path, f) for f in os.listdir(path) if f.endswith(".csv")
    )
    if not files:
        return Table.empty(schema)
    return Table.concat([read_csv(f, schema, header) for f in files])


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

"""Columnar in-memory table — the subset of the JAX package's
``core/table.py`` that the feature assembler needs: construction from a
dict of columns, row count, column access and the numeric matrix."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import numpy as np

from .schema import FLOAT, INT, STRING, TIMESTAMP, Field, Schema


def _coerce(values: Any, f: Field) -> np.ndarray:
    arr = np.asarray(values)
    if f.dtype == TIMESTAMP:
        return arr.astype("datetime64[ns]")
    if f.dtype == STRING:
        return arr.astype(object)
    if f.dtype == INT and arr.dtype.kind in "fc":
        # keep a NaN-capable representation
        return arr.astype(np.float64)
    return arr.astype(f.numpy_dtype)


@dataclass(frozen=True)
class Table:
    schema: Schema
    columns: dict[str, np.ndarray]

    def __post_init__(self) -> None:
        lens = {len(v) for v in self.columns.values()}
        if len(lens) > 1:
            raise ValueError(f"ragged columns: lengths {lens}")
        if set(self.columns) != set(self.schema.names):
            raise ValueError(
                f"columns {sorted(self.columns)} != schema {sorted(self.schema.names)}"
            )

    def __len__(self) -> int:
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values())))

    @property
    def num_rows(self) -> int:
        return len(self)

    @classmethod
    def from_dict(cls, data: Mapping[str, Any], schema: Schema | None = None) -> "Table":
        if schema is None:
            fields = []
            for k, v in data.items():
                a = np.asarray(v)
                if a.dtype.kind in "USO":
                    fields.append(Field(k, STRING))
                elif a.dtype.kind == "M":
                    fields.append(Field(k, TIMESTAMP))
                elif a.dtype.kind in "iu" or a.dtype.kind == "b":
                    fields.append(Field(k, INT))
                else:
                    fields.append(Field(k, FLOAT))
            schema = Schema(fields)
        cols = {f.name: _coerce(data[f.name], f) for f in schema}
        return cls(schema, cols)

    def numeric_matrix(self, names: Sequence[str], dtype=np.float64) -> np.ndarray:
        for n in names:
            if not self.schema.field(n).is_numeric:
                raise TypeError(f"column {n!r} is not numeric")
        if not names:
            return np.empty((len(self), 0), dtype=dtype)
        return np.stack([self.columns[n].astype(dtype) for n in names], axis=1)

"""Columnar in-memory table — the subset of the JAX package's
``core/table.py`` that the feature stages and the hospital pipeline's
model stage and the SQL engine need: construction, column access, the
numeric matrix, the relational steps concat / empty / select / mask /
limit / with_column / na_drop / between, and the device-column cache the
compiled SQL executor reads."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from ..obs.registry import global_registry
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
    # device-column cache: (name, device) → tensor, filled lazily by the
    # compiled SQL executor so repeated queries over the same snapshot
    # never re-transfer a column.  Not part of the value (compare=False);
    # sound because Table is immutable — every relational op builds a
    # NEW Table.
    _device_cache: dict = field(default_factory=dict, compare=False, repr=False)

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

    def column(self, name: str) -> np.ndarray:
        return self.columns[name]

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

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

    @classmethod
    def concat(cls, tables: Sequence["Table"]) -> "Table":
        if not tables:
            raise ValueError("concat of no tables")
        schema = tables[0].schema
        cols = {
            n: np.concatenate([t.columns[n] for t in tables]) for n in schema.names
        }
        return cls(schema, cols)

    @classmethod
    def empty(cls, schema: Schema) -> "Table":
        return cls(schema, {f.name: np.empty((0,), dtype=f.numpy_dtype) for f in schema})

    def select(self, names: Sequence[str]) -> "Table":
        return Table(self.schema.select(names), {n: self.columns[n] for n in names})

    def mask(self, m: np.ndarray) -> "Table":
        """Rows picked by a boolean mask or an index array."""
        return Table(self.schema, {n: v[m] for n, v in self.columns.items()})

    def limit(self, n: int) -> "Table":
        return Table(self.schema, {k: v[:n] for k, v in self.columns.items()})

    def with_column(self, name: str, values: Any, dtype: str | None = None) -> "Table":
        """``DataFrame.withColumn``: add or replace a column; ``values``
        may be an array or a callable of the table."""
        if callable(values):
            values = values(self)
        arr = np.asarray(values)
        if dtype is None:
            if arr.dtype.kind in "USO":
                dtype = STRING
            elif arr.dtype.kind == "M":
                dtype = TIMESTAMP
            elif arr.dtype.kind in "iub":
                dtype = INT
            else:
                dtype = FLOAT
        f = Field(name, dtype)
        if name in self.schema:
            schema = Schema(tuple(f if g.name == name else g for g in self.schema))
        else:
            schema = self.schema.add(f)
        cols = dict(self.columns)
        cols[name] = _coerce(arr, f)
        return Table(schema, cols)

    def na_drop(self, subset: Sequence[str] | None = None) -> "Table":
        """``DataFrame.na.drop()``: drop rows with a NaN, NaT or None."""
        names = list(subset) if subset else self.schema.names
        keep = np.ones(len(self), dtype=bool)
        for n in names:
            v = self.columns[n]
            if v.dtype.kind == "f":
                keep &= ~np.isnan(v)
            elif v.dtype.kind == "M":
                keep &= ~np.isnat(v)
            elif v.dtype == object:
                keep &= np.array([x is not None and x == x for x in v], dtype=bool)
        return self.mask(keep)

    def between(self, column: str, start: Any, end: Any) -> "Table":
        """The training window: ``WHERE column BETWEEN start AND end``."""
        v = self.columns[column]
        if v.dtype.kind == "M":
            start = np.datetime64(start)
            end = np.datetime64(end)
        return self.mask((v >= start) & (v <= end))

    def numeric_matrix(self, names: Sequence[str], dtype=np.float64) -> np.ndarray:
        for n in names:
            if not self.schema.field(n).is_numeric:
                raise TypeError(f"column {n!r} is not numeric")
        if not names:
            return np.empty((len(self), 0), dtype=dtype)
        return np.stack([self.columns[n].astype(dtype) for n in names], axis=1)

    def device_column(self, name: str, device) -> torch.Tensor:
        """The column as a tensor on ``device``, cached per (name, device)
        so reruns of a query over this snapshot transfer nothing.

        Device representation (the compiled SQL executor's contract):
        float → float64 (NaN null), int/bool → int64 (null-free),
        timestamp → int64 nanoseconds (NaT keeps its int64 sentinel).
        String/object columns never transfer.
        """
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        key = (name, str(dev))
        arr = self._device_cache.get(key)
        # a miss is a fresh host→device transfer
        global_registry().inc(
            "sql.cache.device.hit" if arr is not None else "sql.cache.device.miss"
        )
        if arr is None:
            col = self.columns[name]
            k = col.dtype.kind
            if k == "f":
                host = col.astype(np.float64, copy=False)
            elif k in "iub":
                host = col.astype(np.int64, copy=False)
            elif k == "M":
                host = col.astype("datetime64[ns]", copy=False).view(np.int64)
            else:
                raise TypeError(
                    f"column {name!r} ({col.dtype}) has no device "
                    "representation — string columns stay on the host"
                )
            arr = torch.from_numpy(np.ascontiguousarray(host)).to(dev)
            self._device_cache[key] = arr
        return arr

    def device_cache_info(self) -> dict:
        """Cached (column, device) entries and their total device bytes —
        the no-re-transfer evidence."""
        return {
            "entries": sorted(self._device_cache),
            "bytes": int(sum(a.numel() * a.element_size()
                             for a in self._device_cache.values())),
        }

"""Columnar in-memory table — the JAX package's ``core/table.py``, the
DataFrame replacement: construction (dicts, pandas, Arrow), column
access, the numeric matrix, the relational steps (concat / empty / select
/ drop / mask / filter / limit / with_column / with_column_renamed /
na_drop / between / sample / sort_by / group_count), Spark's ``show`` and
``describe``, the pandas and Arrow hand-offs, the device-column cache the
compiled SQL executor reads, and ``to_device``, the one host → device
boundary of the pipeline (a padded, weighted dataset on the card, or laid
over a mesh).  Everything but ``device_column`` and ``to_device`` is host
numpy and needs no card."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Sequence

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
    def from_pandas(cls, df, schema: Schema | None = None) -> "Table":
        return cls.from_dict({c: df[c].to_numpy() for c in df.columns}, schema)

    @classmethod
    def from_arrow(cls, batch) -> "Table":
        """From a pyarrow Table or RecordBatch, the schema inferred:
        strings come back as objects, timestamps as ``datetime64[ns]``."""
        return cls.from_dict({name: batch.column(name).to_numpy(zero_copy_only=False)
                              for name in batch.schema.names})

    def to_arrow(self):
        import pyarrow as pa

        return pa.table({n: self.columns[n] for n in self.schema.names})

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

    def drop(self, *names: str) -> "Table":
        """Spark's ``df.drop``: remove columns (unknown names ignored,
        Spark semantics)."""
        gone = set(names)
        return self.select([c for c in self.schema.names if c not in gone])

    def mask(self, m: np.ndarray) -> "Table":
        """Rows picked by a boolean mask or an index array."""
        return Table(self.schema, {n: v[m] for n, v in self.columns.items()})

    def filter(self, predicate: Callable[["Table"], np.ndarray]) -> "Table":
        """Rows where ``predicate(table)`` (a boolean array) is true."""
        return self.mask(np.asarray(predicate(self), dtype=bool))

    def limit(self, n: int) -> "Table":
        return Table(self.schema, {k: v[:n] for k, v in self.columns.items()})

    def sample(self, fraction: float, seed: int = 0) -> "Table":
        """Spark's ``df.sample(fraction, seed)``: a per-row Bernoulli draw
        from numpy's ``default_rng(seed)`` (the row count varies around
        n·fraction, as Spark's does)."""
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"fraction must be in [0, 1], got {fraction}")
        keep = np.random.default_rng(seed).random(len(self)) < fraction
        return self.mask(keep)

    def with_column_renamed(self, existing: str, new: str) -> "Table":
        """Spark's ``withColumnRenamed`` (a no-op when ``existing`` is
        absent, as in Spark); a rename onto another existing column raises
        (Spark would make duplicate columns, which a Table cannot hold)."""
        if existing not in self.columns:
            return self
        if new in self.columns and new != existing:
            raise ValueError(
                f"cannot rename {existing!r} to {new!r}: a column named "
                f"{new!r} already exists"
            )
        fields = [
            Field(new, f.dtype, f.nullable) if f.name == existing else f
            for f in self.schema.fields
        ]
        return Table(
            Schema(fields),
            {(new if k == existing else k): v for k, v in self.columns.items()},
        )

    def sort_by(self, column: str) -> "Table":
        """Rows in ascending order of ``column`` (a stable sort)."""
        return self.mask(np.argsort(self.columns[column], kind="stable"))

    def group_count(self, column: str) -> dict[Any, int]:
        """{value: row count} of ``column``, in ascending value order."""
        vals, counts = np.unique(self.columns[column], return_counts=True)
        return dict(zip(vals.tolist(), counts.tolist()))

    def show(self, n: int = 20, truncate: int = 20) -> None:
        """Spark's ``df.show()``: print the first ``n`` rows as an
        ASCII-boxed table, string cells truncated to ``truncate`` chars
        (0: no truncation)."""
        names = list(self.columns)

        def fmt(v) -> str:
            if (
                v is None
                or (isinstance(v, float) and np.isnan(v))
                or (isinstance(v, (np.datetime64, np.timedelta64)) and np.isnat(v))
            ):
                return "NULL"
            s = f"{v:.6g}" if isinstance(v, (float, np.floating)) else str(v)
            if truncate and len(s) > truncate:
                # Spark: an ellipsis only where there is room for it
                s = s[:truncate] if truncate < 4 else s[: truncate - 3] + "..."
            return s

        rows = [[fmt(self.columns[c][i]) for c in names] for i in range(min(n, len(self)))]
        widths = [
            max(len(c), *(len(r[j]) for r in rows)) if rows else len(c)
            for j, c in enumerate(names)
        ]
        bar = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
        print(bar)
        print("|" + "|".join(f" {c:<{w}} " for c, w in zip(names, widths)) + "|")
        print(bar)
        for r in rows:
            print("|" + "|".join(f" {v:<{w}} " for v, w in zip(r, widths)) + "|")
        print(bar)
        if len(self) > n:
            print(f"only showing top {n} rows")

    def describe(self, *cols: str) -> "Table":
        """Spark's ``df.describe()``: count / mean / stddev / min / max of
        each numeric column (all of them when none is named), as a Table
        whose first column is ``summary``."""
        names = list(cols) if cols else self.schema.numeric_names()
        # the non-numeric check, on a 0-row slice
        self.limit(0).numeric_matrix(names)
        if "summary" in names:
            raise ValueError(
                "describe() reserves the output column name 'summary' — "
                "rename that column first"
            )
        out: dict[str, Any] = {
            "summary": np.asarray(["count", "mean", "stddev", "min", "max"], dtype=object)
        }
        for c in names:
            v = self.columns[c].astype(np.float64)
            ok = v[~np.isnan(v)]
            if ok.size:
                # Spark reports the sample stddev (ddof=1; NaN for one row)
                sd = float(np.std(ok, ddof=1)) if ok.size > 1 else np.nan
                stats = [float(ok.size), float(ok.mean()), sd, float(ok.min()), float(ok.max())]
            else:
                stats = [0.0, np.nan, np.nan, np.nan, np.nan]
            out[c] = np.asarray(stats)
        return Table.from_dict(out)

    def to_pandas(self):
        """Spark's ``toPandas``."""
        import pandas as pd

        return pd.DataFrame({n: self.columns[n] for n in self.schema.names})

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
            from ..parallel.mesh import single_device_mesh
            from ..parallel.partitioner import family

            # the SQL executor's placement, declared in the one
            # partitioner: replicated over the one-entry mesh of ``dev``
            arr = family("sql").put("column", host, single_device_mesh(dev)).block(0, 0)
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

    def to_device(self, feature_cols: Sequence[str], label_col: str | None = None,
                  mesh=None, device=None):
        """The feature columns (and the label) as a padded, weighted
        dataset on ``device`` (default the card), or over ``mesh`` (not
        both): a one-entry mesh gives a DeviceDataset on its device, a
        larger one a ShardedDataset."""
        from ..parallel.sharding import device_dataset

        x = self.numeric_matrix(feature_cols)
        y = self.columns[label_col].astype(np.float64) if label_col else None
        return device_dataset(x, y, device=device, mesh=mesh)

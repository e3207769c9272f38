"""Imputer — fill missing values with a per-column statistic (the JAX
package's ``features/imputer.py``; host numpy over a Table).

Parity with ``pyspark.ml.feature.Imputer``: strategy "mean" (default),
"median" or "mode"; missing = NaN, and also a configurable sentinel
(``missing_value``).  Fit computes the statistic of each input column
over its non-missing entries; transform writes filled copies to the
output columns.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..core.table import Table
from ..io.model_io import register_model


def _missing(v: np.ndarray, missing_value: float) -> np.ndarray:
    # Spark's Imputer treats NaN as missing in addition to the sentinel: a
    # NaN never passes through, nor enters a surrogate
    if np.isnan(missing_value):
        return np.isnan(v)
    return np.isnan(v) | (v == missing_value)


@register_model("ImputerModel")
@dataclass(frozen=True)
class ImputerModel:
    input_cols: tuple[str, ...]
    output_cols: tuple[str, ...]
    surrogates: tuple[float, ...]
    missing_value: float = float("nan")

    def _artifacts(self):
        return (
            "ImputerModel",
            {
                "input_cols": list(self.input_cols),
                "output_cols": list(self.output_cols),
                "surrogates": [float(s) for s in self.surrogates],
                "missing_value": (
                    "nan" if np.isnan(self.missing_value) else float(self.missing_value)
                ),
            },
            {},
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        mv = params.get("missing_value", "nan")
        return cls(
            tuple(params["input_cols"]),
            tuple(params["output_cols"]),
            tuple(float(s) for s in params["surrogates"]),
            float("nan") if mv == "nan" else float(mv),
        )

    def transform(self, table: Table) -> Table:
        out = table
        for ic, oc, s in zip(self.input_cols, self.output_cols, self.surrogates):
            v = out.column(ic).astype(np.float64).copy()
            v[_missing(v, self.missing_value)] = s
            out = out.with_column(oc, v, dtype="float")
        return out


@dataclass(frozen=True)
class Imputer:
    input_cols: Sequence[str]
    output_cols: Sequence[str] | None = None
    strategy: str = "mean"  # Spark's default; "median" | "mode"
    missing_value: float = float("nan")

    def fit(self, table: Table) -> ImputerModel:
        if self.strategy not in ("mean", "median", "mode"):
            raise ValueError(f"strategy must be mean|median|mode, got {self.strategy!r}")
        outs = tuple(self.output_cols) if self.output_cols else tuple(self.input_cols)
        if len(outs) != len(tuple(self.input_cols)):
            raise ValueError("input_cols and output_cols lengths differ")
        surrogates = []
        for c in self.input_cols:
            v = table.column(c).astype(np.float64)
            ok = v[~_missing(v, self.missing_value)]
            if ok.size == 0:
                raise ValueError(f"column {c!r} has no non-missing values to impute from")
            if self.strategy == "mean":
                surrogates.append(float(ok.mean()))
            elif self.strategy == "median":
                surrogates.append(float(np.median(ok)))
            else:  # mode: the smallest most frequent value (Spark's tie-break)
                vals, counts = np.unique(ok, return_counts=True)
                surrogates.append(float(vals[np.argmax(counts)]))
        return ImputerModel(tuple(self.input_cols), outs, tuple(surrogates), self.missing_value)

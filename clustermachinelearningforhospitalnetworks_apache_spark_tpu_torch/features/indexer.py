"""StringIndexer — categorical string column → dense integer codes (the
JAX package's ``features/indexer.py``; host numpy over a Table).

The reference script imports ``StringIndexer`` and never uses it; here it
is a working stage: labels in Spark's default ``frequencyDesc`` order,
ties broken lexicographically.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.table import Table
from ..io.model_io import register_model


@register_model("StringIndexerModel")
@dataclass(frozen=True)
class StringIndexerModel:
    input_col: str
    output_col: str
    labels: tuple[str, ...]
    handle_invalid: str = "error"  # "error" | "keep" | "skip"

    def _artifacts(self):
        return (
            "StringIndexerModel",
            {
                "input_col": self.input_col,
                "output_col": self.output_col,
                "labels": list(self.labels),
                "handle_invalid": self.handle_invalid,
            },
            {},
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(
            params["input_col"],
            params["output_col"],
            tuple(params["labels"]),
            params.get("handle_invalid", "error"),
        )

    def transform(self, table: Table) -> Table:
        lut = {v: i for i, v in enumerate(self.labels)}
        vals = table.column(self.input_col)
        out = np.empty(len(vals), dtype=np.int64)
        invalid = []
        for i, v in enumerate(vals):
            code = lut.get(v)
            if code is None:
                if self.handle_invalid == "error":
                    raise ValueError(f"unseen label {v!r} in {self.input_col}")
                code = len(self.labels)  # "keep": the extra bucket
                invalid.append(i)
            out[i] = code
        t = table.with_column(self.output_col, out, dtype="int")
        if self.handle_invalid == "skip" and invalid:
            keep = np.ones(len(t), dtype=bool)
            keep[invalid] = False
            t = t.mask(keep)
        return t


@dataclass(frozen=True)
class StringIndexer:
    input_col: str
    output_col: str
    handle_invalid: str = "error"

    def fit(self, table: Table) -> StringIndexerModel:
        vals, counts = np.unique(table.column(self.input_col).astype(str), return_counts=True)
        order = np.lexsort((vals, -counts))  # frequency descending, then lexicographic
        return StringIndexerModel(
            self.input_col, self.output_col, tuple(vals[order].tolist()), self.handle_invalid
        )

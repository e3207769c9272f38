"""Bucketizer — continuous column → bucket index by split points (the JAX
package's ``features/bucketizer.py``; host numpy over a Table).

Parity with ``pyspark.ml.feature.Bucketizer``: ``splits`` is a strictly
increasing list of n+1 boundaries defining n buckets; values land in
``[splits[i], splits[i+1])`` (the last bucket is closed on both ends).
``handle_invalid`` covers **NaN only** (Spark semantics): "error" raises,
"keep" routes NaN to an extra bucket n, "skip" drops those rows.  A
non-NaN value outside the split range ALWAYS raises, under every mode —
cover open ranges with ±inf boundary splits, exactly as in Spark.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..core.table import Table
from ..io.model_io import register_model


@register_model("Bucketizer")
@dataclass(frozen=True)
class Bucketizer:
    splits: Sequence[float]
    input_col: str = ""
    output_col: str = ""
    handle_invalid: str = "error"  # "error" | "keep" | "skip"

    def __post_init__(self):
        s = np.asarray(self.splits, dtype=np.float64)
        if s.ndim != 1 or s.size < 3:
            raise ValueError("splits needs >=3 boundaries (>=2 buckets)")
        if not np.all(np.diff(s) > 0):
            raise ValueError("splits must be strictly increasing")
        if self.handle_invalid not in ("error", "keep", "skip"):
            raise ValueError(
                f"handle_invalid must be error|keep|skip, got {self.handle_invalid!r}"
            )

    def _artifacts(self):
        return (
            "Bucketizer",
            {
                "splits": list(map(float, self.splits)),
                "input_col": self.input_col,
                "output_col": self.output_col,
                "handle_invalid": self.handle_invalid,
            },
            {},
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(
            tuple(params["splits"]), params["input_col"],
            params["output_col"], params.get("handle_invalid", "error"),
        )

    @property
    def num_buckets(self) -> int:
        return len(self.splits) - 1

    def transform(self, table: Table) -> Table:
        s = np.asarray(self.splits, dtype=np.float64)
        v = table.column(self.input_col).astype(np.float64)
        idx = np.searchsorted(s, v, side="right") - 1
        # the top boundary is inclusive (Spark: last bucket closed both ends)
        idx[v == s[-1]] = self.num_buckets - 1
        # handle_invalid covers NaN only: a non-NaN value outside the split
        # range raises under every mode
        out_of_range = ~np.isnan(v) & ((v < s[0]) | (v > s[-1]))
        if out_of_range.any():
            bad = v[out_of_range][0]
            raise ValueError(
                f"value {bad!r} in {self.input_col!r} is outside the split "
                f"range [{s[0]}, {s[-1]}]; Bucketizer splits must cover the "
                "data (use -inf/inf boundary splits for open ranges)"
            )
        invalid = np.isnan(v)
        if invalid.any():
            if self.handle_invalid == "error":
                raise ValueError(
                    f"NaN in {self.input_col!r} (handle_invalid='error'); "
                    "use 'keep' or 'skip'"
                )
            idx[invalid] = self.num_buckets  # "keep": the extra bucket
        out = table.with_column(self.output_col, idx.astype(np.int64), dtype="int")
        if self.handle_invalid == "skip" and invalid.any():
            out = out.mask(~invalid)
        return out

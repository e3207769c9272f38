"""QuantileDiscretizer — fit quantile split points, transform through a
Bucketizer (the JAX package's ``features/discretizer.py``; host numpy).

Parity with ``pyspark.ml.feature.QuantileDiscretizer``: fit computes
``num_buckets`` quantile boundaries of a column and returns a
:class:`~.bucketizer.Bucketizer` (Spark's contract: the fitted model IS a
Bucketizer), with duplicate quantiles collapsed, so a low-cardinality
column yields fewer buckets.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.table import Table
from .bucketizer import Bucketizer


@dataclass(frozen=True)
class QuantileDiscretizer:
    num_buckets: int
    input_col: str
    output_col: str
    handle_invalid: str = "error"

    def __post_init__(self):
        if self.num_buckets < 2:
            raise ValueError(f"num_buckets must be >= 2, got {self.num_buckets}")

    def fit(self, table: Table) -> Bucketizer:
        v = table.column(self.input_col).astype(np.float64)
        v = v[~np.isnan(v)]
        if v.size == 0:
            raise ValueError(f"column {self.input_col!r} has no non-NaN values")
        qs = np.linspace(0, 1, self.num_buckets + 1)[1:-1]
        inner = np.unique(np.quantile(v, qs))
        # only a boundary at the column minimum is degenerate (bucket 0
        # would be empty); one at the maximum is valid: the closed top
        # bucket holds exactly the maximum values, as in Spark
        inner = inner[inner > v.min()]
        if inner.size == 0:
            # a heavily skewed column (e.g. 80% zeros): every quantile sits
            # at the minimum; fall back to interior unique-value boundaries
            inner = np.unique(v)[1:][: self.num_buckets - 1]
        splits = np.concatenate([[-np.inf], inner, [np.inf]])
        if len(splits) < 3:
            raise ValueError(
                f"column {self.input_col!r} has too few distinct values to "
                f"form 2 buckets"
            )
        return Bucketizer(
            tuple(splits.tolist()), self.input_col, self.output_col,
            self.handle_invalid,
        )

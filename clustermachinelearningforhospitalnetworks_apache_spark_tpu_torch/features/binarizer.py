"""Label binarization: ``when(col > threshold, 1).otherwise(0)`` — the
reference script's LOS_binary label, strictly greater than the threshold
(the JAX package's ``features/binarizer.py``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.table import Table


@dataclass(frozen=True)
class Binarizer:
    input_col: str
    output_col: str
    threshold: float

    def transform(self, table: Table) -> Table:
        v = table.column(self.input_col).astype(np.float64)
        return table.with_column(
            self.output_col, (v > self.threshold).astype(np.int64), dtype="int"
        )

"""VectorAssembler — column list → dense feature matrix.

Parity with ``pyspark.ml.feature.VectorAssembler``: "a vector column" is
a column-stacked host matrix, which reaches the device in one transfer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..core.table import Table


@dataclass(frozen=True)
class VectorAssembler:
    input_cols: Sequence[str]
    output_col: str = "features"

    def transform_matrix(self, table: Table, dtype=np.float64) -> np.ndarray:
        """The matrix itself — the form every estimator consumes."""
        return table.numeric_matrix(list(self.input_cols), dtype=dtype)

    def transform(self, table: Table) -> "AssembledTable":
        return AssembledTable(
            table=table,
            feature_cols=tuple(self.input_cols),
            features=self.transform_matrix(table),
            output_col=self.output_col,
        )


@dataclass(frozen=True)
class AssembledTable:
    """A table plus its assembled feature matrix (host float64)."""

    table: Table
    feature_cols: tuple[str, ...]
    features: np.ndarray
    output_col: str = "features"

    def __len__(self) -> int:
        return len(self.table)

    def to_device(self, device=None):
        """The features as a padded :class:`~..data.DeviceDataset` on
        ``device`` (default the card)."""
        from ..data import device_dataset

        return device_dataset(self.features, device=device)

"""VectorAssembler — column list → dense feature matrix.

Parity with ``pyspark.ml.feature.VectorAssembler``: "a vector column" is
a column-stacked host matrix, which reaches the device in one transfer —
or, from a compiled query's :class:`~..core.sql_compile.DeviceView`
(``transform_device``), a matrix stacked on the device itself.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..core.table import Table
from ..io.model_io import register_model


@register_model("VectorAssembler")
@dataclass(frozen=True)
class VectorAssembler:
    input_cols: Sequence[str]
    output_col: str = "features"

    def _artifacts(self):
        """A Pipeline stage saves as the JAX package's: params, no arrays."""
        return ("VectorAssembler",
                {"input_cols": list(self.input_cols), "output_col": self.output_col}, {})

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(tuple(params["input_cols"]), params.get("output_col", "features"))

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

    def transform_device(self, view, label_col: str | None = None, na_drop: bool = True,
                         compact: bool = False):
        """Fused assembly: a compiled row-level query's result
        (:class:`~..core.sql_compile.DeviceView`) → a
        :class:`~..data.DeviceDataset` on the view's device, with no row
        passing through the host.  The filter mask becomes the weight
        column and ``na_drop`` folds Spark's ``na.drop()`` over the feature
        and label columns into it: invalid rows stay in place, zeroed,
        with weight 0.  ``compact=True`` gathers the valid rows, in source
        order, into exactly as many rows (one host sync: their count)."""
        from ..core.schema import LABEL_COL
        from ..core.sql_compile import compact_dataset, one_empty_row
        from ..data import DeviceDataset

        if label_col is None and LABEL_COL in view.out_names:
            label_col = LABEL_COL
        x, y, w = view.assemble(self.input_cols, label_col=label_col, na_drop=na_drop)
        if compact:
            x, y, w = compact_dataset(x, y, w)
        elif x.shape[0] == 0:
            x, y, w = one_empty_row(x)
        return DeviceDataset(x=x, y=y, w=w)


@dataclass(frozen=True)
class AssembledTable:
    """A table plus its assembled feature matrix (host float64)."""

    table: Table
    feature_cols: tuple[str, ...]
    features: np.ndarray
    output_col: str = "features"

    def __len__(self) -> int:
        return len(self.table)

    def label(self, name: str) -> np.ndarray:
        return self.table.column(name).astype(np.float64)

    def to_device(self, label_col: str | None = None, device=None,
                  weight_col: str | None = None, mesh=None):
        """The features as a padded :class:`~..data.DeviceDataset` on
        ``device`` (default the card), or over ``mesh`` (a
        ``ShardedDataset`` for more than one shard, the one-entry mesh's
        device otherwise).  The label comes from the source table:
        ``label_col``, else the canonical LOS label when the table has it;
        ``weight_col`` names non-negative sample weights."""
        from ..core.schema import LABEL_COL
        from ..parallel.sharding import device_dataset

        if label_col is None and LABEL_COL in self.table.schema:
            label_col = LABEL_COL
        y = self.label(label_col) if label_col else None
        w = None
        if weight_col:
            if weight_col not in self.table.schema:
                raise KeyError(
                    f"weight_col {weight_col!r} is not a column of the "
                    f"table; available: {self.table.schema.names}"
                )
            w = self.table.column(weight_col).astype(np.float64)
        return device_dataset(self.features, y, device=device, weights=w, mesh=mesh)

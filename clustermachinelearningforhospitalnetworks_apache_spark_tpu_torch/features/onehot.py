"""OneHotEncoder — integer category column(s) → indicator columns (the JAX
package's ``features/onehot.py``; host numpy over a Table).

Parity with ``pyspark.ml.feature.OneHotEncoder``: fit learns each input
column's category count (max code + 1); transform appends one 0/1 column
per category, named ``<output_col>_<i>``.  ``drop_last=True`` (Spark's
default) omits the final category, so the encoding stays full-rank for
linear models.  Named scalar columns stand in for Spark's sparse vector:
``VectorAssembler`` then stacks the indicator columns a model needs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..core.table import Table
from ..io.model_io import register_model


def _check_handle_invalid(value: str) -> None:
    if value not in ("error", "keep"):
        raise ValueError(
            f"handle_invalid must be error|keep, got {value!r} (Spark's "
            "OneHotEncoder has no 'skip')"
        )


@register_model("OneHotEncoderModel")
@dataclass(frozen=True)
class OneHotEncoderModel:
    input_cols: tuple[str, ...]
    output_cols: tuple[str, ...]
    category_sizes: tuple[int, ...]
    drop_last: bool = True
    handle_invalid: str = "error"  # "error" | "keep" (Spark's vocabulary)

    def __post_init__(self):
        _check_handle_invalid(self.handle_invalid)

    def _artifacts(self):
        return (
            "OneHotEncoderModel",
            {
                "input_cols": list(self.input_cols),
                "output_cols": list(self.output_cols),
                "category_sizes": list(self.category_sizes),
                "drop_last": self.drop_last,
                "handle_invalid": self.handle_invalid,
            },
            {},
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(
            tuple(params["input_cols"]),
            tuple(params["output_cols"]),
            tuple(int(s) for s in params["category_sizes"]),
            bool(params.get("drop_last", True)),
            params.get("handle_invalid", "error"),
        )

    def _effective_size(self, col_index: int) -> int:
        # Spark: handleInvalid="keep" adds an invalid bucket as the last
        # category, so dropLast drops that bucket: every valid category
        # keeps its indicator and invalid rows become all zeros (or, with
        # dropLast=False, get their own indicator column)
        size = self.category_sizes[col_index]
        return size + 1 if self.handle_invalid == "keep" else size

    def output_names(self, col_index: int) -> list[str]:
        eff = self._effective_size(col_index)
        emitted = eff - 1 if self.drop_last else eff
        return [f"{self.output_cols[col_index]}_{i}" for i in range(emitted)]

    def transform(self, table: Table) -> Table:
        out = table
        for ci, (ic, size) in enumerate(zip(self.input_cols, self.category_sizes)):
            codes = out.column(ic).astype(np.int64)
            bad = (codes < 0) | (codes >= size)
            if bad.any():
                if self.handle_invalid == "error":
                    raise ValueError(
                        f"category {int(codes[bad][0])} in {ic!r} is outside "
                        f"[0, {size}) (handle_invalid='error')"
                    )
                codes = np.where(bad, size, codes)  # the invalid bucket
            for i, name in enumerate(self.output_names(ci)):
                out = out.with_column(name, (codes == i).astype(np.int64), dtype="int")
        return out


@dataclass(frozen=True)
class OneHotEncoder:
    input_cols: Sequence[str]
    output_cols: Sequence[str] | None = None
    drop_last: bool = True     # Spark's dropLast default
    handle_invalid: str = "error"

    def __post_init__(self):
        _check_handle_invalid(self.handle_invalid)

    def fit(self, table: Table) -> OneHotEncoderModel:
        outs = tuple(self.output_cols) if self.output_cols else tuple(
            f"{c}_vec" for c in self.input_cols
        )
        if len(outs) != len(tuple(self.input_cols)):
            raise ValueError("input_cols and output_cols lengths differ")
        sizes = []
        for c in self.input_cols:
            codes = table.column(c).astype(np.int64)
            if codes.size and codes.min() < 0:
                raise ValueError(f"negative category code in {c!r}")
            sizes.append(int(codes.max()) + 1 if codes.size else 0)
        return OneHotEncoderModel(
            tuple(self.input_cols), outs, tuple(sizes), self.drop_last, self.handle_invalid,
        )

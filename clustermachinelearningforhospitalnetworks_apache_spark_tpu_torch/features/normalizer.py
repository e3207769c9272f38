"""Row-wise feature transforms: Normalizer, PolynomialExpansion,
IndexToString (the JAX package's ``features/normalizer.py``).

Parity with the ``pyspark.ml.feature`` stages of those names.  All are
stateless transformers (no fit) over the feature matrix — an ndarray, a
tensor (on its device), an AssembledTable or a DeviceDataset — or, for
IndexToString, over a Table column on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations_with_replacement
from math import comb
from typing import Sequence

import numpy as np
import torch

from ..core.table import Table
from ..io.model_io import register_model
from .vector_ops import _dispatch


@register_model("Normalizer")
@dataclass(frozen=True)
class Normalizer:
    """Scale each row to unit p-norm (Spark's default p=2)."""

    p: float = 2.0

    def __post_init__(self):
        if not self.p >= 1.0:
            raise ValueError(f"p must be >= 1, got {self.p}")

    def _artifacts(self):
        return ("Normalizer", {"p": self.p}, {})

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(float(params.get("p", 2.0)))

    def transform(self, x):
        return _dispatch(x, self._rows)

    def _rows(self, x):
        if isinstance(x, torch.Tensor):
            if self.p == 2.0:
                norm = torch.sqrt((x * x).sum(dim=1))
            elif self.p == 1.0:
                norm = x.abs().sum(dim=1)
            elif np.isinf(self.p):
                norm = x.abs().amax(dim=1)
            else:
                norm = (x.abs() ** self.p).sum(dim=1) ** (1.0 / self.p)
            return x / torch.where(norm > 0, norm, 1.0)[:, None].to(x.dtype)
        if self.p == 2.0:
            norm = np.sqrt((x * x).sum(axis=1))
        elif self.p == 1.0:
            norm = np.abs(x).sum(axis=1)
        elif np.isinf(self.p):
            norm = np.abs(x).max(axis=1)
        else:
            norm = (np.abs(x) ** self.p).sum(axis=1) ** (1.0 / self.p)
        safe = np.where(norm > 0, norm, 1.0)
        return x / safe[:, None].astype(x.dtype)


@register_model("PolynomialExpansion")
@dataclass(frozen=True)
class PolynomialExpansion:
    """Every monomial of the input features up to ``degree`` (no bias
    term), in sklearn's ``PolynomialFeatures(include_bias=False)`` column
    order; Spark's expansion spans the same monomials."""

    degree: int = 2

    def __post_init__(self):
        if not 1 <= self.degree <= 4:
            raise ValueError(f"degree must be in [1, 4], got {self.degree}")

    def _artifacts(self):
        return ("PolynomialExpansion", {"degree": self.degree}, {})

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(int(params.get("degree", 2)))

    @staticmethod
    def _exponents(d: int, degree: int) -> np.ndarray:
        """(n_out, d) exponent rows, graded-lexicographic as sklearn's."""
        rows = []
        for deg in range(1, degree + 1):
            for combo in combinations_with_replacement(range(d), deg):
                e = np.zeros(d, dtype=np.int64)
                for i in combo:
                    e[i] += 1
                rows.append(e)
        return np.stack(rows)

    def num_outputs(self, d: int) -> int:
        return comb(d + self.degree, self.degree) - 1

    def transform(self, x):
        return _dispatch(x, self._rows)

    def _rows(self, x):
        exps = self._exponents(x.shape[1], self.degree)
        if isinstance(x, torch.Tensor):
            e = torch.as_tensor(exps, dtype=x.dtype, device=x.device)
            return torch.stack([torch.prod(x ** e[j][None, :], dim=1)
                                for j in range(len(exps))], dim=1)
        cols = [np.prod(x ** np.asarray(e, dtype=x.dtype)[None, :], axis=1) for e in exps]
        return np.stack(cols, axis=1)


@register_model("IndexToString")
@dataclass(frozen=True)
class IndexToString:
    """Integer codes → the original labels (StringIndexer's inverse): maps
    a prediction column back to category strings, Spark's usual last
    stage.  Host numpy over a Table."""

    input_col: str
    output_col: str
    labels: Sequence[str]

    def _artifacts(self):
        return (
            "IndexToString",
            {"input_col": self.input_col, "output_col": self.output_col,
             "labels": list(self.labels)},
            {},
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(params["input_col"], params["output_col"], tuple(params["labels"]))

    def transform(self, table: Table) -> Table:
        codes = table.column(self.input_col).astype(np.int64)
        lut = np.asarray(list(self.labels), dtype=object)
        if codes.size and (codes.min() < 0 or codes.max() >= len(lut)):
            bad = codes[(codes < 0) | (codes >= len(lut))][0]
            raise ValueError(
                f"code {int(bad)} in {self.input_col!r} has no label (0..{len(lut) - 1})"
            )
        return table.with_column(self.output_col, lut[codes], dtype="string")

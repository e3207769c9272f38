"""RFormula + VectorSizeHint (the JAX package's ``features/rformula.py``;
host numpy over a Table).

RFormula compiles an R model formula into the feature pipeline Spark
would build: ``label ~ term + term - term`` with ``.`` (all columns but
the label), ``:`` interactions, and automatic encoding — numeric columns
pass through, string columns one-hot encode (R's treatment contrast:
k−1 dummies against the first level by frequency), and the label string-
indexes when categorical.  fit → RFormulaModel whose ``transform``
yields the framework's :class:`AssembledTable` (features + label ride
together), so ``RFormula(formula=...)`` drops in front of any estimator
exactly like Spark's.

VectorSizeHint validates/declares a feature width mid-pipeline (Spark
uses it to make streaming schemas size-stable).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch

from ..core.table import Table
from ..data import DeviceDataset
from ..io.model_io import register_model
from .assembler import AssembledTable


def _parse_formula(formula: str):
    """'y ~ a + b + a:b - c' → (label, added terms, removed terms).
    A term is a tuple of column names (len > 1 = interaction)."""
    if "~" not in formula:
        raise ValueError(f"formula needs '~': {formula!r}")
    lhs, rhs = formula.split("~", 1)
    label = lhs.strip()
    if not label:
        raise ValueError(f"formula needs a label on the left of '~': {formula!r}")
    added: list[tuple[str, ...]] = []
    removed: list[tuple[str, ...]] = []
    # split on + and - at top level, tracking sign
    for sign, chunk in re.findall(r"([+-]?)\s*([^+-]+)", rhs):
        term = chunk.strip()
        if not term:
            continue
        cols = tuple(c.strip() for c in term.split(":"))
        if any(not c for c in cols):
            raise ValueError(f"empty column in term {term!r}")
        (removed if sign == "-" else added).append(cols)
    if not added:
        raise ValueError(f"formula has no feature terms: {formula!r}")
    return label, added, removed


@register_model("RFormulaModel")
@dataclass(frozen=True)
class RFormulaModel:
    label: str
    terms: tuple                    # ((col, ...), ...) resolved terms
    # per string column: category levels ordered by DESCENDING frequency;
    # the LAST (least frequent) level is the dropped base — Spark's
    # StringIndexer(frequencyDesc) + OneHotEncoder(dropLast) composition
    levels: tuple                   # ((col, (level, ...)), ...)
    label_levels: tuple = ()        # () = numeric label
    feature_names: tuple = ()

    def _encode_column(self, t: Table, col: str) -> tuple[np.ndarray, list[str]]:
        """→ (matrix block, names) for one column."""
        lv = dict(self.levels)
        vals = t.column(col)
        if col in lv:
            levels = lv[col]
            out = np.zeros((len(t), max(len(levels) - 1, 1)), np.float32)
            index = {l: i for i, l in enumerate(levels)}
            for r, v in enumerate(np.asarray(vals, object)):
                # levels persist as strings (JSON); look up in str space
                i = index.get(str(v))
                if i is None:
                    raise ValueError(
                        f"unseen level {v!r} in column {col!r}; fit saw "
                        f"{list(levels)}"
                    )
                if i < len(levels) - 1:   # LAST level is the dropped base
                    out[r, i] = 1.0
            names = [f"{col}_{l}" for l in levels[:-1]] or [col]
            return out, names
        return (
            np.asarray(vals, np.float32).reshape(len(t), 1),
            [col],
        )

    def transform(self, t: Table) -> AssembledTable:
        blocks: list[np.ndarray] = []
        names: list[str] = []
        for term in self.terms:
            mats, nms = zip(*(self._encode_column(t, c) for c in term))
            block, bn = mats[0], list(nms[0])
            for m2, n2 in zip(mats[1:], nms[1:]):
                # interaction: pairwise products, left-major naming
                # (explicit width — reshape(n, -1) is ambiguous at n=0,
                # which the fit-time 0-row name resolution hits)
                block = (block[:, :, None] * m2[:, None, :]).reshape(
                    len(t), block.shape[1] * m2.shape[1]
                )
                bn = [f"{a}:{b}" for a in bn for b in n2]
            blocks.append(block.astype(np.float32))
            names.extend(bn)
        features = np.concatenate(blocks, axis=1)

        # label: numeric passthrough | string-indexed (fit-time levels)
        if self.label in t.columns:
            if self.label_levels:
                index = {l: i for i, l in enumerate(self.label_levels)}
                yvals = np.asarray(t.column(self.label), object)
                y = np.empty(len(t), np.float32)
                for r, v in enumerate(yvals):
                    if str(v) not in index:
                        raise ValueError(
                            f"unseen label level {v!r}; fit saw "
                            f"{list(self.label_levels)}"
                        )
                    y[r] = index[str(v)]
            else:
                y = np.asarray(t.column(self.label), np.float32)
            t = t.with_column(self.label, y)
        return AssembledTable(
            table=t, feature_cols=tuple(names), features=features
        )

    def _artifacts(self):
        return (
            "RFormulaModel",
            {
                "label": self.label,
                "terms": [list(tm) for tm in self.terms],
                "levels": [[c, list(ls)] for c, ls in self.levels],
                "label_levels": list(self.label_levels),
                "feature_names": list(self.feature_names),
            },
            {},
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(
            label=params["label"],
            terms=tuple(tuple(tm) for tm in params["terms"]),
            levels=tuple((c, tuple(ls)) for c, ls in params["levels"]),
            label_levels=tuple(params.get("label_levels", [])),
            feature_names=tuple(params.get("feature_names", [])),
        )


@dataclass(frozen=True)
class RFormula:
    """``formula="label ~ col + col2 + col:col2"`` (also ``.`` for
    every non-label column, ``- col`` to exclude)."""

    formula: str = ""

    def fit(self, t: Table) -> RFormulaModel:
        if not isinstance(t, Table):
            raise TypeError(f"RFormula fits a Table; got {type(t).__name__}")
        label, added, removed = _parse_formula(self.formula)
        if label not in t.columns:
            raise KeyError(
                f"label {label!r} is not a column; available: {sorted(t.columns)}"
            )
        # '- a' removes the main effect a; '- a:b' removes that
        # interaction (order-insensitive, like R)
        removed_terms = {frozenset(tm) for tm in removed}
        removed_singles = {tm[0] for tm in removed if len(tm) == 1}
        terms: list[tuple[str, ...]] = []
        for tm in added:
            if tm == (".",):
                for c in t.columns:
                    if (
                        c != label
                        and c not in removed_singles
                        and (c,) not in terms
                    ):
                        terms.append((c,))
                continue
            for c in tm:
                if c not in t.columns:
                    raise KeyError(
                        f"column {c!r} is not in the table; available: "
                        f"{sorted(t.columns)}"
                    )
            if tm not in terms and frozenset(tm) not in removed_terms:
                terms.append(tm)
        if not terms:
            raise ValueError(f"formula resolved to zero terms: {self.formula!r}")

        def is_string(col: str) -> bool:
            return np.asarray(t.column(col)).dtype.kind in "OUS"

        levels = []
        for col in sorted({c for tm in terms for c in tm}):
            if is_string(col):
                vals, counts = np.unique(
                    np.asarray(t.column(col), object).astype(str),
                    return_counts=True,
                )
                order = np.argsort(-counts, kind="stable")
                levels.append((col, tuple(vals[order])))
        label_levels = ()
        if is_string(label):
            vals, counts = np.unique(
                np.asarray(t.column(label), object).astype(str),
                return_counts=True,
            )
            order = np.argsort(-counts, kind="stable")
            label_levels = tuple(vals[order])
        model = RFormulaModel(
            label=label,
            terms=tuple(terms),
            levels=tuple(levels),
            label_levels=label_levels,
        )
        # resolve output names from a ZERO-row slice (names depend only
        # on terms/levels; re-encoding the full table would double fit
        # cost for a throwaway array)
        return RFormulaModel(
            label=model.label,
            terms=model.terms,
            levels=model.levels,
            label_levels=model.label_levels,
            feature_names=model.transform(t.limit(0)).feature_cols,
        )

    def fit_transform(self, t: Table) -> AssembledTable:
        return self.fit(t).transform(t)


@register_model("VectorSizeHint")
@dataclass(frozen=True)
class VectorSizeHint:
    """Assert (and declare) the feature width mid-pipeline — Spark uses
    this to give streaming pipelines size-stable schemas.  ``handle_
    invalid``: "error" raises on mismatch (default), "skip" is
    meaningless for dense matrices and raises at construction."""

    size: int = 0
    handle_invalid: str = "error"

    def __post_init__(self):
        if self.size < 1:
            raise ValueError(f"size must be >= 1, got {self.size}")
        if self.handle_invalid != "error":
            raise ValueError(
                "only handle_invalid='error' is meaningful for dense "
                f"matrices; got {self.handle_invalid!r}"
            )

    def _artifacts(self):
        return ("VectorSizeHint", {"size": self.size}, {})

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(size=int(params["size"]))

    def transform(self, x):
        if isinstance(x, AssembledTable):
            feats = x.features
        elif isinstance(x, DeviceDataset):
            feats = x.x
        else:
            feats = x if isinstance(x, torch.Tensor) else np.asarray(x)
        width = feats.shape[1]
        if width != self.size:
            raise ValueError(
                f"VectorSizeHint(size={self.size}) saw {width} features"
            )
        return x

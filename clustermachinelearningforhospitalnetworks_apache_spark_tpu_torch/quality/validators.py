"""Row-level validation: vectorized constraints → accept / reject + reason.

The rung BELOW the stream's batch quarantine in the validation ladder: a
batch is no longer an all-or-nothing unit.  A :class:`RowValidator` is
compiled once from the canonical schema (non-nullable fields become
``null:`` checks) plus a declarative :class:`ConstraintSet` (ranges for
vitals/LOS, categorical domains, monotone timestamps, non-null sets),
and splits every typed table into

* **accepted** rows — the table the pipeline keeps training/serving on;
* **rejected** rows — each carrying machine-readable reasons
  (``"range:length_of_stay"``, ``"null:event_time"``, …) that land in
  ``<ckpt>/quarantine/rows/`` with a per-reason histogram.

Design stance on nulls: a *missing* numeric value (NaN) is NOT a reject
by default — the feature layer owns missingness (``features/imputer.py``
fills it, ``features/robust.py`` scales around it).  Validation rejects
what imputation cannot fix: values that are present but *wrong* (out of
range, outside a domain, time running backwards).  Reject only what you
cannot repair; repair the rest downstream.

All checks are vectorized numpy over whole columns — validation cost is
a handful of comparisons per column, small beside the parse.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable

import numpy as np

from ..core.schema import FEATURE_COLS, LABEL_COL, Schema
from ..core.table import Table

# machine-readable reason prefixes (full reason: "<prefix>:<column>")
REASON_RANGE = "range"
REASON_DOMAIN = "domain"
REASON_NULL = "null"
REASON_NON_FINITE = "non_finite"
REASON_MONOTONE = "monotone"
# parse-stage reasons (emitted by io/csv.py salvage, same vocabulary)
REASON_PARSE = "parse"
REASON_FIELD_COUNT = "field_count"


@dataclass(frozen=True)
class Constraint:
    """One declarative rule; ``kind`` selects the vectorized check."""

    kind: str
    column: str
    lo: float | None = None
    hi: float | None = None
    values: tuple[Any, ...] | None = None
    group_by: str | None = None

    @property
    def reason(self) -> str:
        return f"{self.kind}:{self.column}"


class ConstraintSet:
    """A list of :class:`Constraint` rules, built by chained calls."""

    def __init__(self) -> None:
        self.constraints: list[Constraint] = []

    def range(
        self, column: str, lo: float | None = None, hi: float | None = None
    ) -> "ConstraintSet":
        """Value must lie in [lo, hi] when present (NaN passes — see
        module docstring)."""
        self.constraints.append(Constraint(REASON_RANGE, column, lo=lo, hi=hi))
        return self

    def domain(self, column: str, values: Iterable[Any]) -> "ConstraintSet":
        """Categorical column must be one of ``values`` when present."""
        self.constraints.append(
            Constraint(REASON_DOMAIN, column, values=tuple(values))
        )
        return self

    def not_null(self, *columns: str) -> "ConstraintSet":
        """Column must be present: NaN / NaT / None / "" all reject."""
        for c in columns:
            self.constraints.append(Constraint(REASON_NULL, c))
        return self

    def finite(self, *columns: str) -> "ConstraintSet":
        """±Inf rejects (NaN still passes — it is missing, not wrong)."""
        for c in columns:
            self.constraints.append(Constraint(REASON_NON_FINITE, c))
        return self

    def monotone(self, column: str, group_by: str | None = None) -> "ConstraintSet":
        """Values (typically timestamps) must be non-decreasing within the
        batch, optionally per ``group_by`` key (e.g. per hospital)."""
        self.constraints.append(
            Constraint(REASON_MONOTONE, column, group_by=group_by)
        )
        return self


def hospital_constraints() -> ConstraintSet:
    """Default firewall rules for the reference's 7-field event stream:
    physically-possible ranges for the vitals/occupancy counters and LOS,
    non-null identity/time, finite features.  NaN features pass (routed
    to the imputer); impossible values reject."""
    cs = ConstraintSet()
    cs.not_null("hospital_id", "event_time")
    cs.range("admission_count", 0, 10_000)
    cs.range("current_occupancy", 0, 50_000)
    cs.range("emergency_visits", 0, 5_000)
    cs.range("seasonality_index", 0.0, 10.0)
    cs.range(LABEL_COL, 0.0, 365.0)
    cs.finite(*FEATURE_COLS, LABEL_COL)
    return cs


def _null_mask(v: np.ndarray) -> np.ndarray:
    """True where the value is missing, across all column dtypes."""
    if v.dtype.kind == "f":
        return np.isnan(v)
    if v.dtype.kind == "M":
        return np.isnat(v)
    if v.dtype == object:
        return np.array(
            [x is None or x != x or x == "" for x in v], dtype=bool
        )
    return np.zeros(len(v), dtype=bool)


@dataclass
class ValidationResult:
    """Per-row split of one batch, with machine-readable evidence."""

    accepted: Table
    rejected: Table
    #: reasons aligned with ``rejected`` rows (one list per rejected row)
    reasons: list[list[str]]
    #: reason → number of rows carrying it (a row may carry several)
    histogram: dict[str, int]
    n_input: int

    @property
    def n_rejected(self) -> int:
        return len(self.reasons)

    def reject_records(self, context: str = "") -> list[dict]:
        """Quarantine-ready records: stringified row + reasons."""
        out = []
        cols = self.rejected.schema.names
        for i, reasons in enumerate(self.reasons):
            row = {c: str(self.rejected.columns[c][i]) for c in cols}
            out.append({"context": context, "row": row, "reasons": reasons})
        return out


class RowValidator:
    """Schema + constraints, compiled into one vectorized pass."""

    def __init__(
        self, schema: Schema, constraints: ConstraintSet | None = None
    ):
        self.schema = schema
        cs = ConstraintSet() if constraints is None else constraints
        compiled = list(cs.constraints)
        declared = {
            (c.kind, c.column) for c in compiled if c.kind == REASON_NULL
        }
        # schema nullability compiles to not-null checks too
        for f in schema:
            if not f.nullable and (REASON_NULL, f.name) not in declared:
                compiled.append(Constraint(REASON_NULL, f.name))
        self.constraints = tuple(
            c for c in compiled if c.column in schema
        )

    # ------------------------------------------------------------ checks
    def _check(self, c: Constraint, table: Table) -> np.ndarray:
        """→ boolean OK-mask for one constraint over the whole batch."""
        v = table.columns[c.column]
        null = _null_mask(v)
        if c.kind == REASON_NULL:
            return ~null
        if c.kind == REASON_RANGE:
            x = v.astype(np.float64)
            ok = np.ones(len(v), dtype=bool)
            with np.errstate(invalid="ignore"):
                if c.lo is not None:
                    ok &= ~(x < c.lo)
                if c.hi is not None:
                    ok &= ~(x > c.hi)
            return ok | null  # missing is not out-of-range
        if c.kind == REASON_NON_FINITE:
            x = v.astype(np.float64)
            return ~np.isinf(x)
        if c.kind == REASON_DOMAIN:
            return np.isin(v, np.asarray(c.values, dtype=v.dtype)) | null
        if c.kind == REASON_MONOTONE:
            return self._monotone_ok(table, c)
        raise ValueError(f"unknown constraint kind {c.kind!r}")

    @staticmethod
    def _monotone_ok(table: Table, c: Constraint) -> np.ndarray:
        v = table.columns[c.column]
        x = (
            v.view("i8").astype(np.float64)
            if v.dtype.kind == "M"
            else v.astype(np.float64)
        )
        null = _null_mask(v)
        x = np.where(null, -np.inf, x)  # nulls never break the order

        def run_ok(idx: np.ndarray) -> np.ndarray:
            vals = x[idx]
            prev_max = np.maximum.accumulate(
                np.concatenate([[-np.inf], vals[:-1]])
            )
            return vals >= prev_max

        ok = np.ones(len(v), dtype=bool)
        if c.group_by is None:
            ok = run_ok(np.arange(len(v)))
        else:
            g = table.columns[c.group_by]
            for key in np.unique(g.astype(str)):
                idx = np.flatnonzero(g.astype(str) == key)
                ok[idx] = run_ok(idx)
        return ok | null

    # ------------------------------------------------------------ validate
    def validate(self, table: Table) -> ValidationResult:
        n = len(table)
        if n == 0 or not self.constraints:
            return ValidationResult(
                accepted=table,
                rejected=table.limit(0),
                reasons=[],
                histogram={},
                n_input=n,
            )
        keep = np.ones(n, dtype=bool)
        per_row: dict[int, list[str]] = {}
        histogram: dict[str, int] = {}
        for c in self.constraints:
            ok = self._check(c, table)
            bad = np.flatnonzero(~ok)
            if bad.size:
                histogram[c.reason] = histogram.get(c.reason, 0) + int(bad.size)
                keep[bad] = False
                for i in bad:
                    per_row.setdefault(int(i), []).append(c.reason)
        rej_idx = sorted(per_row)
        return ValidationResult(
            accepted=table.mask(keep),
            rejected=table.mask(~keep),
            reasons=[per_row[i] for i in rej_idx],
            histogram=histogram,
            n_input=n,
        )

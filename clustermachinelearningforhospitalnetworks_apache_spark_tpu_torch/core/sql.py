"""A small SQL subset over columnar Tables — ``Session.sql``'s engine.

The reference exercises exactly one SQL shape (the windowed SELECT at
``mllearnforhospitalnetwork.py:123-128``), but it reaches it through Spark
SQL (SURVEY.md E1), where a projection or a per-hospital GROUP BY is the
same one-liner.  This module covers that working set with a hand-rolled
tokenizer + recursive-descent parser + numpy columnar executor — no
Catalyst, no codegen; d ≪ n tabular queries are host-side column sweeps:

    SELECT [DISTINCT] [* [, extras] | cols | agg(col) | agg(expr)
                       (e.g. SUM(CASE WHEN … END) — conditional
                       aggregation) | arithmetic expressions over
                       cols/aggs/literals (+ - * /, parentheses, unary
                       minus) | CASE WHEN <pred> THEN <expr> […]
                       [ELSE <expr>] END | scalar functions ABS ROUND
                       (HALF_UP, Spark) UPPER LOWER LENGTH COALESCE |
                       window functions: agg(col) OVER ([PARTITION BY
                       cols] [ORDER BY col [DESC]]), ROW_NUMBER / RANK
                       / DENSE_RANK / NTILE(k), LAG/LEAD(col[, offset]),
                       FIRST_VALUE/LAST_VALUE(col) — Spark
                       default frames (whole partition without ORDER
                       BY; RANGE … CURRENT ROW with it, ties share
                       their block's value; out-of-partition offsets
                       are NULL) [AS alias]]
      FROM t [[AS] a] | ( <select …> ) a   (derived tables, also on the
                                            JOIN right side; inner
                                            ORDER BY/LIMIT = top-N)
      [[INNER|LEFT [OUTER]|RIGHT [OUTER]|FULL [OUTER]] JOIN t2 [[AS] b]
       ON a.key = b.key | CROSS JOIN t2] (single-key equi-join,
                                         vectorized hash join; outer
                                         sides null-fill)
      [WHERE <pred> {AND|OR} ...]        predicates: = != <> < <= > >=,
                                         BETWEEN 'a' AND 'b', IS [NOT]
                                         NULL, [NOT] IN (v, …), [NOT]
                                         IN (SELECT …) (uncorrelated
                                         semi/anti-join, Spark's
                                         null-set 3VL), NOT,
                                         parentheses — evaluated under
                                         SQL three-valued logic (UNKNOWN
                                         propagates through AND/OR/NOT
                                         like Spark)
      [GROUP BY cols | exprs]            aggs: COUNT(*) SUM AVG MIN MAX
                                         MEDIAN PERCENTILE_APPROX(col,
                                         p[, acc]) — exact percentile
                                         (acc accepted, ignored);
                                         expression keys (GROUP BY CASE
                                         … END) match select items
                                         syntactically, Spark's rule
      [HAVING <pred over aggregates>]
      [ORDER BY col [ASC|DESC]]
      [LIMIT n]
      [UNION [ALL|DISTINCT] | INTERSECT [DISTINCT] | EXCEPT [DISTINCT]
       <select> …]                       positional column alignment,
                                         left-associative folds with
                                         INTERSECT binding tighter
                                         (standard precedence); a
                                         trailing ORDER BY/LIMIT
                                         applies to the whole chain

Columns may be qualified (``a.col``); unqualified names resolve when
unambiguous across the joined sides (ambiguity raises, like Spark).

Timestamp columns compare against their literals in datetime64 space, so
``WHERE event_time BETWEEN '2025-03-31 22:00:00' AND '…'`` matches the
reference byte-for-byte.
"""

from __future__ import annotations

import os
import re
from collections import deque
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from .sql_parse import (
    _AGG_REF,
    _Query,
    _SelectItem,
    _Union,
    _expr_cols,
    _expr_has_agg,
    parse,
)
from ..device import resolve_device
from ..obs import trace as _trace
from ..obs.registry import global_registry as _global_registry
from .table import Table


def _lower_aggex(e, compute):
    """Replace ``("aggex", agg, inner)`` nodes (aggregates over arbitrary
    expressions — ``sum(CASE WHEN … END)``) and ``("pct", inner, p)``
    percentile nodes with sentinel ``("agg", key)`` atoms whose values
    ``compute(node)`` produced against the SOURCE rows; → (lowered expr,
    {sentinel: value}).  Lets every aggregate-context evaluator keep its
    one name-based atom resolver."""
    replaced: dict[str, Any] = {}

    def walk(node):
        if node is None:
            return None
        k = node[0]
        if k in ("aggex", "pct"):
            key = f"__aggex{len(replaced)}__"
            replaced[key] = compute(node)
            return ("agg", key)
        if k == "neg":
            return ("neg", walk(node[1]))
        if k == "bin":
            return ("bin", node[1], walk(node[2]), walk(node[3]))
        if k == "case":
            return (
                "case",
                [(c, walk(v)) for c, v in node[1]],
                walk(node[2]),
            )
        if k == "fn":
            return ("fn", node[1], [walk(a) for a in node[2]])
        return node

    return walk(e), replaced




def _require_numeric(name: str, v) -> None:
    kind = (
        "f" if np.ndim(v) == 0 and not isinstance(v, str)
        else np.asarray(v).dtype.kind
    )
    if kind in "USO":
        raise ValueError(f"SQL: {name.upper()} expects a numeric argument")


def _require_arity(name: str, vals: list, lo: int, hi: int | None = None):
    hi = lo if hi is None else hi
    if not lo <= len(vals) <= hi:
        want = str(lo) if lo == hi else f"{lo}..{hi}"
        raise ValueError(
            f"SQL: {name.upper()} takes {want} argument(s), got {len(vals)}"
        )


def _eval_fn(name: str, vals: list):
    """Scalar-function application with Spark null semantics (nulls
    propagate except through COALESCE, which exists to absorb them)."""
    if name == "coalesce":
        _require_arity(name, vals, 1, 64)

        def kindclass(v):
            if np.ndim(v) == 0:
                return "str" if isinstance(v, str) else "num"
            k = np.asarray(v).dtype.kind
            return "str" if k in "USO" else "num"

        kinds = {kindclass(v) for v in vals}
        if len(kinds) > 1:
            # np.where would silently stringify the numeric side — Spark
            # raises an analysis error for incompatible COALESCE types
            raise ValueError(
                "SQL: COALESCE arguments mix string and numeric types"
            )
        n = max((np.ndim(v) and len(v)) for v in vals)
        if n == 0:  # all-scalar arguments: first non-null wins
            for v in vals:
                if not (v is None or (isinstance(v, float) and np.isnan(v))):
                    return v
            return np.nan
        cols = [
            np.full(n, v) if np.ndim(v) == 0 else np.asarray(v) for v in vals
        ]
        out = cols[0].copy()
        for c in cols[1:]:
            miss = _null_mask(out)
            if not miss.any():
                break
            # object columns (string CASE/LEFT JOIN fills) assign per-mask
            out = np.where(miss, c, out) if out.dtype != object else _obj_fill(
                out, c, miss
            )
        return out
    if name == "abs":
        _require_arity(name, vals, 1)
        _require_numeric(name, vals[0])
        return np.abs(vals[0])
    if name == "round":
        _require_arity(name, vals, 1, 2)
        _require_numeric(name, vals[0])
        if len(vals) == 2 and np.ndim(vals[1]) != 0:
            raise ValueError("SQL: ROUND scale must be a literal, not a column")
        d = int(vals[1]) if len(vals) == 2 else 0
        from decimal import ROUND_HALF_UP, Decimal, localcontext

        q = Decimal(1).scaleb(-d)

        def r1(x: float) -> float:
            if not np.isfinite(x):
                return x
            # Decimal(repr(x)) mirrors Spark's BigDecimal.valueOf(double)
            # (shortest-repr), so 0.285 rounds UP to 0.29 — float scaling
            # would see 0.28499999… and round down.  A wide local context
            # keeps quantize legal for huge magnitudes (default prec=28
            # raises InvalidOperation at ~1e28).
            with localcontext() as ctx:
                ctx.prec = 330
                return float(
                    Decimal(repr(float(x))).quantize(q, ROUND_HALF_UP)
                )

        x = vals[0]
        if np.ndim(x) == 0:
            return r1(float(x))
        return np.array([r1(float(v)) for v in np.asarray(x, np.float64)])
    if name == "length":
        _require_arity(name, vals, 1)
        return _str_fn(name, vals[0], len, out_dtype=np.float64)
    if name in ("upper", "lower"):
        _require_arity(name, vals, 1)
        f = str.upper if name == "upper" else str.lower
        return _str_fn(name, vals[0], f)
    if name == "date_trunc":
        _require_arity(name, vals, 2)
        if not isinstance(vals[0], str):
            raise ValueError(
                "SQL: DATE_TRUNC unit must be a string literal "
                "('year'|'quarter'|'month'|'week'|'day'|'hour'|'minute'|"
                "'second')"
            )
        return _date_trunc(vals[0].lower(), _as_datetime(name, vals[1]))
    if name == "unix_timestamp":
        _require_arity(name, vals, 1)
        ts = _as_datetime(name, vals[0])
        secs = ts.astype("datetime64[s]").astype(np.float64)
        return np.where(np.isnat(ts), np.nan, secs) if np.ndim(ts) else (
            np.nan if np.isnat(ts) else float(secs)
        )
    if name == "datediff":
        _require_arity(name, vals, 2)
        end = _as_datetime(name, vals[0]).astype("datetime64[D]")
        start = _as_datetime(name, vals[1]).astype("datetime64[D]")
        days = (end - start).astype(np.float64)
        nat = np.isnat(end) | np.isnat(start)
        if np.ndim(days):
            return np.where(nat, np.nan, days)
        return np.nan if nat else float(days)
    raise ValueError(f"SQL: unknown function {name!r}")


def _as_datetime(name: str, v):
    """Coerce a function argument to datetime64[ns]: timestamp columns pass
    through, string literals parse (Spark's implicit cast), anything else
    is a labeled analysis error."""
    if isinstance(v, str):
        try:
            return np.datetime64(v.replace(" ", "T"))
        except ValueError:
            raise ValueError(
                f"SQL: {name.upper()} got an unparseable timestamp literal "
                f"{v!r}"
            ) from None
    arr = np.asarray(v)
    if arr.dtype.kind != "M":
        raise ValueError(
            f"SQL: {name.upper()} expects a timestamp argument, got "
            f"{arr.dtype}"
        )
    return arr if np.ndim(v) else arr[()]


def _date_trunc(unit: str, ts):
    """Spark ``date_trunc``: floor to the unit, result stays a timestamp.
    NaT propagates through every path (numpy casts keep it NaT)."""
    simple = {"year": "Y", "month": "M", "day": "D",
              "hour": "h", "minute": "m", "second": "s"}
    if unit in simple:
        return ts.astype(f"datetime64[{simple[unit]}]").astype("datetime64[ns]")
    if unit == "quarter":
        months = ts.astype("datetime64[M]")
        m_idx = months.astype(np.int64)  # months since 1970-01
        floored = (months - (m_idx % 3).astype("timedelta64[M]"))
        out = floored.astype("datetime64[ns]")
        # integer arithmetic on NaT yields garbage offsets — restore NaT
        return np.where(np.isnat(ts), np.datetime64("NaT", "ns"), out) \
            if np.ndim(ts) else (np.datetime64("NaT", "ns") if np.isnat(ts) else out)
    if unit == "week":
        # Spark truncates to Monday; datetime64[W] weeks start Thursday
        # (the epoch's weekday), so floor on day index instead
        days = ts.astype("datetime64[D]")
        d_idx = days.astype(np.int64)          # 1970-01-01 = Thursday
        monday = days - ((d_idx + 3) % 7).astype("timedelta64[D]")
        out = monday.astype("datetime64[ns]")
        return np.where(np.isnat(ts), np.datetime64("NaT", "ns"), out) \
            if np.ndim(ts) else (np.datetime64("NaT", "ns") if np.isnat(ts) else out)
    raise ValueError(
        f"SQL: DATE_TRUNC does not support unit {unit!r} "
        "(year|quarter|month|week|day|hour|minute|second)"
    )


def _obj_fill(out: np.ndarray, c: np.ndarray, miss: np.ndarray) -> np.ndarray:
    out = out.copy()
    out[miss] = c[miss]
    return out


def _str_fn(name, v, f, out_dtype=object):
    """Apply a str→x function elementwise; None/NaN input → null output
    (None for object results, NaN for numeric ones); non-string values
    raise the engine's labeled error, not a raw TypeError."""
    if np.ndim(v) == 0:
        if isinstance(v, str):
            return f(v)
        if v is None or (isinstance(v, float) and np.isnan(v)):
            return np.nan
        raise ValueError(f"SQL: {name.upper()} expects a string argument")
    arr = np.asarray(v, object)
    null = _null_mask(arr)
    bad = [s for s in arr[~null] if not isinstance(s, str)]
    if bad:
        raise ValueError(
            f"SQL: {name.upper()} expects a string column, got value "
            f"{bad[0]!r}"
        )
    if out_dtype is object:
        out = np.empty(len(arr), object)
        out[null] = None
    else:
        out = np.full(len(arr), np.nan)
    out[~null] = [f(s) for s in arr[~null]]
    return out


def _eval_expr(getcol, e):
    """Evaluate an expression AST to a column (or scalar for pure-literal
    trees).  Arithmetic follows Spark SQL: ``/`` is float division and a
    zero divisor yields null (NaN), nulls propagate through every op."""
    k = e[0]
    if k == "col" or k == "agg":
        return getcol(e[1])
    if k == "lit":
        return e[1]
    if k == "neg":
        return -_eval_expr(getcol, e[1])
    if k == "case":
        branches, default = e[1], e[2]
        conds = [
            np.asarray(_eval_cond(getcol, c), bool) for c, _ in branches
        ]
        vals = [_eval_expr(getcol, v) for _, v in branches]
        if default is None:
            # implicit ELSE is NULL in the result's own type family
            kinds = {
                np.asarray(v).dtype.kind if np.ndim(v) else
                ("U" if isinstance(v, str) else "f")
                for v in vals
            }
            if kinds & set("USO"):
                dflt = None                       # object NULL
            elif "M" in kinds:
                dflt = np.datetime64("NaT")
            elif "m" in kinds:
                dflt = np.timedelta64("NaT")
            else:
                dflt = np.nan
        else:
            dflt = _eval_expr(getcol, default)
        try:
            return np.select(conds, vals, default=dflt)
        except TypeError as exc:
            raise ValueError(
                "SQL: CASE branches (and ELSE) have incompatible types: "
                f"{exc}"
            ) from None
    if k == "fn":
        return _eval_fn(e[1], [_eval_expr(getcol, a) for a in e[2]])
    _, op, le, re_ = e
    lv = _eval_expr(getcol, le)
    rv = _eval_expr(getcol, re_)
    if op == "+":
        return lv + rv
    if op == "-":
        return lv - rv
    if op == "*":
        return lv * rv
    with np.errstate(divide="ignore", invalid="ignore"):
        den = np.asarray(rv, np.float64)
        out = np.asarray(lv, np.float64) / np.where(den == 0, np.nan, den)
    return out





def _coerce(col: np.ndarray, lit: Any) -> Any:
    """Literal → the column's comparison space (datetime64 for timestamps)."""
    if np.issubdtype(col.dtype, np.datetime64):
        return np.datetime64(str(lit).replace(" ", "T"))
    if np.issubdtype(col.dtype, np.number) and isinstance(lit, str):
        return float(lit)
    return lit


def _eval_cond(getcol, cond) -> np.ndarray:
    """Evaluate a predicate tree to the rows-that-pass mask; ``getcol(name)
    -> np.ndarray`` resolves (possibly qualified / aggregate) column
    references.  SQL three-valued logic: a row passes only when the
    predicate is exactly TRUE (UNKNOWN filters like FALSE), but UNKNOWN
    still short-circuits correctly through AND/OR/NOT — ``FALSE AND
    NULL`` is FALSE, so ``NOT (a > 5 AND b > 5)`` keeps a row with a ≤ 5
    and b null, exactly like Spark."""
    t, _ = _eval_cond3(getcol, cond)
    return t


def _eval_cond3(getcol, cond) -> tuple[np.ndarray, np.ndarray]:
    """→ (true_mask, unknown_mask) under SQL three-valued logic."""
    kind = cond[0]
    if kind == "and":
        t1, n1 = _eval_cond3(getcol, cond[1])
        t2, n2 = _eval_cond3(getcol, cond[2])
        f1, f2 = ~t1 & ~n1, ~t2 & ~n2
        return t1 & t2, ~(f1 | f2) & (n1 | n2)
    if kind == "or":
        t1, n1 = _eval_cond3(getcol, cond[1])
        t2, n2 = _eval_cond3(getcol, cond[2])
        t = t1 | t2
        return t, ~t & (n1 | n2)
    if kind == "not":
        t, n = _eval_cond3(getcol, cond[1])
        return ~t & ~n, n
    if kind == "isnull":
        col = getcol(cond[1])
        # IS NULL is never UNKNOWN — it inspects nullness itself
        return _null_mask(col), np.zeros(len(col), bool)
    if kind in ("in", "notin"):
        _, name, vals = cond
        col = getcol(name)
        null = _null_mask(col)
        out = np.zeros(len(col), bool)
        cv = col[~null]
        hit = np.zeros(len(cv), bool)
        for v in vals:
            hit |= cv == _coerce(col, v)
        out[~null] = ~hit if kind == "notin" else hit
        return out, null
    if kind in ("in3", "notin3"):
        # materialized IN (SELECT …) set, Spark 3VL with subquery nulls:
        # x IN (…, NULL) is TRUE on a match, else UNKNOWN; x NOT IN
        # (…, NULL) is FALSE on a match, else UNKNOWN (never TRUE)
        _, name, values, has_null = cond
        col = getcol(name)
        null = _null_mask(col)
        # coerce set values to the operand's comparison space (the same
        # _coerce the literal-IN path applies — a numeric column vs a
        # string-typed subquery must cast, not silently miss); a value
        # Spark's cast would null out joins the null-set instead
        coerced = []
        for v in list(values):
            if isinstance(v, (np.datetime64, np.timedelta64)):
                # already in comparison space; .item() would flatten to
                # raw integer ns and _coerce would re-parse it as a
                # garbage year-precision datetime
                coerced.append(v)
                continue
            v = v.item() if isinstance(v, np.generic) else v
            try:
                coerced.append(_coerce(col, v))
            except (ValueError, TypeError):
                has_null = True
        values = np.asarray(coerced)
        if len(values) == 0 and not has_null:
            # empty build side: IN is FALSE and NOT IN is TRUE for EVERY
            # row — null operands included (Spark's semi/anti-join rule)
            n = len(col)
            zero = np.zeros(n, bool)
            return (zero, zero) if kind == "in3" else (np.ones(n, bool), zero)
        hit = np.zeros(len(col), bool)
        cv = col[~null]
        h = np.isin(cv, values) if len(values) else np.zeros(len(cv), bool)
        hit[~null] = h
        if kind == "in3":
            true = hit
            unknown = null | (~hit & ~null & has_null)
        else:
            true = (
                np.zeros(len(col), bool) if has_null else (~null & ~hit)
            )
            unknown = null | (has_null & ~hit & ~null)
        return true, unknown
    if kind in ("insub", "notinsub"):
        raise ValueError(
            "SQL: IN (SELECT …) must be lowered before evaluation — "
            "it is only supported in WHERE/HAVING"
        )
    if kind == "between":
        _, name, lo, hi = cond
        col = getcol(name)
        null = _null_mask(col)
        out = np.zeros(len(col), bool)
        cv = col[~null]
        out[~null] = (cv >= _coerce(col, lo)) & (cv <= _coerce(col, hi))
        return out, null
    _, name, op, lit = cond
    col = getcol(name)
    v = _coerce(col, lit)
    # a null operand makes the comparison UNKNOWN (incl. !=); masking
    # nulls out BEFORE comparing also keeps object columns with
    # LEFT-JOIN None fills from raising raw TypeErrors
    null = _null_mask(col)
    out = np.zeros(len(col), bool)
    cv = col[~null]
    out[~null] = {
        "=": lambda: cv == v,
        "!=": lambda: cv != v,
        "<": lambda: cv < v,
        "<=": lambda: cv <= v,
        ">": lambda: cv > v,
        ">=": lambda: cv >= v,
    }[op]()
    return out, null


def _resolve_name(t: Table, name: str, aliases: set[str]) -> str:
    """A (possibly qualified) reference → the table's actual column name.

    Joined tables carry fully-qualified ``alias.col`` columns: unqualified
    names resolve when exactly one side has the column (ambiguity raises,
    Spark's rule); single-table queries accept ``alias.col`` for the FROM
    alias."""
    if name in t.columns:
        return name
    if "." in name:
        qual, base = name.split(".", 1)
        if qual in aliases and base in t.columns:
            return base
    else:
        hits = [c for c in t.columns if c.endswith("." + name)]
        if len(hits) == 1:
            return hits[0]
        if len(hits) > 1:
            raise ValueError(
                f"SQL: column {name!r} is ambiguous across {sorted(hits)}; "
                "qualify it"
            )
    raise ValueError(f"SQL: unknown column {name!r}")


def _null_fill_take(col: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``col[idx]`` with idx == -1 rows becoming null (LEFT JOIN fills):
    ints widen to float64 so NaN exists; objects get None."""
    missing = idx < 0
    if col.shape[0] == 0:
        # LEFT JOIN against an empty right table: every row is a null fill
        if np.issubdtype(col.dtype, np.datetime64):
            return np.full(idx.shape, np.datetime64("NaT"), col.dtype)
        if np.issubdtype(col.dtype, np.number):
            return np.full(idx.shape, np.nan, np.float64)
        return np.full(idx.shape, None, object)
    out = col[np.maximum(idx, 0)]
    if not missing.any():
        return out
    if np.issubdtype(out.dtype, np.datetime64):
        out = out.copy()
        out[missing] = np.datetime64("NaT")
    elif np.issubdtype(out.dtype, np.number):
        out = out.astype(np.float64)
        out[missing] = np.nan
    else:
        out = out.astype(object)
        out[missing] = None
    return out


def _equi_join(
    lt: Table, rt: Table, lk: np.ndarray, rk: np.ndarray,
    kind: str, r_alias: str,
) -> Table:
    """Vectorized single-key hash join (factorize → sort → searchsorted —
    O((n+m)·log m), no Python per-row loop).  Null keys never match (SQL);
    ``kind="left"`` keeps unmatched left rows with null right columns.
    The left table's column names pass through (already qualified for
    chained joins); the right side's get the ``r_alias.`` prefix."""
    lnull, rnull = _null_mask(lk), _null_mask(rk)
    lv = np.flatnonzero(~lnull)
    rv = np.flatnonzero(~rnull)
    try:
        both = np.concatenate([lk[lv], rk[rv]])
        # np.unique SORTS: mixed-type object keys (str vs int) raise here,
        # inside the guard, instead of surfacing a raw TypeError
        codes = np.unique(both, return_inverse=True)[1]
    except (TypeError, np.exceptions.DTypePromotionError) as e:
        raise ValueError(
            f"SQL: JOIN keys have incomparable types "
            f"({lk.dtype} vs {rk.dtype}): {e}"
        ) from e
    lc, rc = codes[: len(lv)], codes[len(lv):]
    order = np.argsort(rc, kind="stable")
    rcs = rc[order]
    start = np.searchsorted(rcs, lc, "left")
    end = np.searchsorted(rcs, lc, "right")
    cnt = end - start                              # matches per valid left row
    tot = int(cnt.sum())
    within = np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    ri_matched = rv[order[np.repeat(start, cnt) + within]]

    cnt_full = np.zeros(len(lk), np.int64)
    cnt_full[lv] = cnt
    # which LEFT rows survive unmatched: left + full keep them
    out_cnt = (
        np.maximum(cnt_full, 1) if kind in ("left", "full") else cnt_full
    )
    li = np.repeat(np.arange(len(lk)), out_cnt)
    total = int(out_cnt.sum())
    ri = np.full(total, -1, np.int64)
    ri[np.repeat(cnt_full > 0, out_cnt)] = ri_matched

    if kind in ("right", "full"):
        # append unmatched RIGHT rows with null left columns (null right
        # keys are unmatched by definition — SQL outer-join semantics)
        matched_right = np.zeros(len(rk), bool)
        matched_right[ri_matched] = True
        extra = np.flatnonzero(~matched_right)
        li = np.concatenate([li, np.full(len(extra), -1, np.int64)])
        ri = np.concatenate([ri, extra])
        cols: dict[str, Any] = {
            c: _null_fill_take(lt.column(c), li) for c in lt.columns
        }
    else:
        cols = {c: lt.column(c)[li] for c in lt.columns}
    for c in rt.columns:
        cols[f"{r_alias}.{c}"] = _null_fill_take(rt.column(c), ri)
    return Table.from_dict(cols)


def _row_codes(cols) -> np.recarray:
    """Columns → packed per-row codes with null-safe equality (every
    NaN/NaT/None folds to one code) — the ONE copy of the row-identity
    rule shared by DISTINCT, the set operations, and GROUP BY."""
    return np.rec.fromarrays([_group_codes(c) for c in cols])


def _distinct_rows(t: Table) -> Table:
    """Row-level DISTINCT via per-column group codes (nulls equal)."""
    if len(t) == 0 or not t.columns:
        return t
    packed = _row_codes([t.column(c) for c in t.columns])
    _, first = np.unique(packed, return_index=True)
    return t.mask(np.sort(first))




def _group_codes(col: np.ndarray) -> np.ndarray:
    """Column → integer group codes with all nulls sharing one code."""
    if np.issubdtype(col.dtype, np.datetime64):
        # NaT views as one fixed int64, so unique collapses every null
        return np.unique(col.astype(np.int64), return_inverse=True)[1]
    if np.issubdtype(col.dtype, np.floating):
        return np.unique(col, return_inverse=True, equal_nan=True)[1]
    if col.dtype == object:
        # sorted-rank factorization shared with the compiled executor
        # (raw np.unique would raise comparing the None fills LEFT JOIN
        # writes against str): every null folds to ONE code sorting
        # last, like float NaN.  Codes being order-isomorphic to the
        # values is what lets compiled GROUP BY over strings — which
        # encodes before filtering — land in exactly this group order.
        from .sql_compile import string_group_codes

        return string_group_codes(col)[0]
    return np.unique(col, return_inverse=True)[1]


def _null_mask(vals: np.ndarray) -> np.ndarray:
    """True where a value is this engine's null (NaN / NaT / None in
    object columns — LEFT JOIN writes None into unmatched object cells)."""
    if np.issubdtype(vals.dtype, np.floating):
        return np.isnan(vals)
    if np.issubdtype(vals.dtype, np.datetime64):
        return np.isnat(vals)
    if vals.dtype == object:
        return np.fromiter(
            (
                v is None or (isinstance(v, float) and v != v)
                for v in vals
            ),
            bool,
            count=len(vals),
        )
    return np.zeros(vals.shape, bool)


def _check_agg_dtype(vals: np.ndarray, agg: str) -> None:
    if agg in ("sum", "avg") and not np.issubdtype(vals.dtype, np.number):
        raise ValueError(
            f"SQL: {agg.upper()} needs a numeric column, got {vals.dtype}"
        )


def _aggregate(vals: np.ndarray, agg: str) -> Any:
    """Whole-column aggregate with Spark SQL null semantics: nulls are
    skipped; an all-null input yields null (NaN) — COUNT counts non-null."""
    ok = vals[~_null_mask(vals)]
    if agg == "count":
        return len(ok)
    _check_agg_dtype(vals, agg)
    if ok.size == 0:
        return np.nan
    f = {"sum": np.sum, "avg": np.mean, "min": np.min, "max": np.max}[agg]
    return f(ok.astype(np.float64) if np.issubdtype(ok.dtype, np.number) else ok)


def _require_pct_numeric(vals: np.ndarray) -> None:
    if vals.dtype.kind in "USOMm":
        raise ValueError(
            "SQL: MEDIAN/PERCENTILE_APPROX expects a numeric column"
        )


def _grouped_percentile(src: np.ndarray, p: float, starts, order_idx):
    """Per-group EXACT percentile (Spark's percentile_approx is an
    approximation; exact is a conservative superset at these scales) —
    a per-group loop over sorted slices (group count ≪ rows)."""
    _require_pct_numeric(src)
    s = src[order_idx]
    bounds = np.r_[starts, len(s)]
    out = np.empty(len(starts), np.float64)
    for i in range(len(starts)):
        seg = s[bounds[i]:bounds[i + 1]]
        seg = seg[~_null_mask(seg)]
        out[i] = float(np.percentile(seg, p * 100.0)) if seg.size else np.nan
    return out


def _grouped_aggregate(src: np.ndarray, agg: str, starts, order_idx):
    """Per-group aggregate via one sort + ``ufunc.reduceat`` — O(n), not
    O(groups × n) boolean scans.  Null (NaN/NaT) entries are skipped,
    all-null groups yield null (NaN/NaT — Spark semantics)."""
    s = src[order_idx]
    null = _null_mask(s)
    nn = np.add.reduceat((~null).astype(np.int64), starts)
    if agg == "count":
        return nn
    _check_agg_dtype(s, agg)
    if np.issubdtype(s.dtype, np.datetime64):
        # reduce in int64 view (np.where cannot mix float fills into
        # datetime64); all-null groups come back as NaT
        si = s.astype(np.int64)
        fill = np.iinfo(np.int64).max if agg == "min" else np.iinfo(np.int64).min
        red = np.minimum.reduceat if agg == "min" else np.maximum.reduceat
        out = red(np.where(null, fill, si), starts).astype(s.dtype)
        out[nn == 0] = np.datetime64("NaT")
        return out
    sf = s.astype(np.float64) if np.issubdtype(s.dtype, np.number) else s
    if agg in ("sum", "avg"):
        total = np.add.reduceat(np.where(null, 0.0, sf), starts)
        out = total if agg == "sum" else total / np.maximum(nn, 1)
    elif agg == "min":
        out = np.minimum.reduceat(np.where(null, np.inf, sf), starts)
    else:
        out = np.maximum.reduceat(np.where(null, -np.inf, sf), starts)
    return np.where(nn > 0, out, np.nan)


#: process-wide default for the compiled path (CMLHN_SQL_COMPILE=0 turns
#: the whole dispatch off and every query runs the numpy interpreter)
def _compile_enabled() -> bool:
    return os.environ.get("CMLHN_SQL_COMPILE", "1").lower() not in (
        "0", "false", "no",
    )


class SqlCompileUnsupported(ValueError):
    """Raised by ``execute(..., mode="compile")`` when the plan has
    fallback nodes — carries the per-node reasons so tests and callers
    can see exactly which construct forced the interpreter."""

    def __init__(self, query: str, reasons):
        self.reasons = tuple(reasons)
        detail = "; ".join(f"{op}: {why}" for op, why in self.reasons)
        super().__init__(
            f"SQL: query is not fully compilable ({detail or 'no plan'}) "
            f"— {query!r}"
        )


@dataclass(frozen=True)
class DispatchRecord:
    """One ``execute`` decision: which executor ran and, on a fallback,
    the per-plan-node reasons — the observability surface that records
    fallback decisions per plan node.  The ``"view"`` route: the query
    was answered from a fresh materialized view matched by plan
    fingerprint."""

    query: str
    route: str                     # "compiled" | "interpreter" | "view"
    reasons: tuple = ()            # ((node_op, reason), ...) when fallback
    fingerprint: str | None = None


#: bounded transcript of recent dispatch decisions (newest last)
_DISPATCH_LOG: deque = deque(maxlen=256)

#: the one copy of each canonical fallback reason (execute / explain /
#: compile_rowlevel must never drift apart on these)
REASON_SETOP = ("query", "set operations run on the interpreter")
REASON_JOIN_SUBQUERY = ("query", "joins/subqueries run on the interpreter")
REASON_DISABLED = (
    "query", "compiled dispatch disabled (CMLHN_SQL_COMPILE=0)",
)


def record_dispatch(
    query: str, route: str, reasons=(), fingerprint: str | None = None
) -> None:
    """Append one dispatch decision — the shared bookkeeping behind
    :func:`last_dispatch`, used by ``execute`` and the fused path.
    Every decision also lands on the process metrics registry
    (``sql.dispatch.compiled`` / ``sql.dispatch.interpreter``,
    ``sql.fallback_nodes``), so exporters see the route mix without
    walking the bounded transcript."""
    _DISPATCH_LOG.append(
        DispatchRecord(query, route, tuple(reasons), fingerprint)
    )
    g = _global_registry()
    g.inc(f"sql.dispatch.{route}")
    if reasons:
        g.inc("sql.fallback_nodes", len(reasons))


def last_dispatch() -> DispatchRecord | None:
    return _DISPATCH_LOG[-1] if _DISPATCH_LOG else None


def dispatch_counts() -> dict[str, int]:
    """Route histogram over the retained dispatch window."""
    out: dict[str, int] = {}
    for r in _DISPATCH_LOG:
        out[r.route] = out.get(r.route, 0) + 1
    return out


def explain(query: str, resolve_table) -> dict:
    """Planner view of a query WITHOUT running it: route it would take,
    plan fingerprint, one entry per plan node with its supported/
    fallback decision, and each node's **incremental**
    decision — ``"incremental"`` vs ``"full-recompute:<reason>"`` — so
    materialized-view coverage is observable per clause.  The top-level
    ``view_maintenance`` key summarizes: ``"incremental"`` when a view
    over this plan would be delta-maintained, else the sorted reasons."""
    from .sql_plan import plan_query
    from .sql_views import plan_is_incremental

    node = parse(query)
    if not isinstance(node, _Query):
        return {
            "route": "interpreter",
            "nodes": [],
            "fallback": [REASON_SETOP],
            "view_maintenance": [REASON_SETOP[1]],
        }
    plan = plan_query(node, resolve_table)
    if plan is None:
        return {
            "route": "interpreter",
            "nodes": [],
            "fallback": [REASON_JOIN_SUBQUERY],
            "view_maintenance": [REASON_JOIN_SUBQUERY[1]],
        }
    fallback = list(plan.fallback_reasons())
    route = "compiled" if plan.fully_supported else "interpreter"
    if route == "compiled" and not _compile_enabled():
        # report what execute() will actually do under the kill switch
        route = "interpreter"
        fallback = [REASON_DISABLED]
    inc_ok, inc_reasons = plan_is_incremental(plan)
    if not _compile_enabled():
        # the kill switch stops view maintenance too (the partials are
        # compiled kernels) — explain must not report "incremental"
        # while every view is serving full recomputes
        from .sql_views import FULL_COMPILE_DISABLED

        inc_ok, inc_reasons = False, [FULL_COMPILE_DISABLED]
    out = {
        "route": route,
        "fingerprint": plan.fingerprint,
        "nodes": plan.explain(),  # ONE copy of the per-node dict shape
        "fallback": fallback,
        "view_maintenance": "incremental" if inc_ok else inc_reasons,
    }
    # zone-map prune preview: when the snapshot came from an unbounded
    # table and the plan has a WHERE, the planner says — from manifests
    # alone, no data read — how much of history the compiled scan would
    # skip.  The key is present only then, so plain-table explains stay
    # what they were.
    origin = getattr(plan.source, "_unbounded_origin", None)
    if origin is not None and plan.filter is not None:
        try:
            out["prune"] = origin.prune_stats(
                plan.filter, getattr(plan.source, "_origin_upto", None))
        except Exception:
            pass  # a broken manifest must not break explain
    return out


def execute(query: str, resolve_table, mode: str = "auto", views=None,
            device=None) -> Table:
    """Run a query; ``resolve_table(name) -> Table`` supplies FROM/JOIN.

    Dispatch (the Flare move): single-table SELECTs whose whole plan
    lowers to the supported columnar subset run on the compiled executor
    (``core/sql_compile.py``: torch ops over device-held column tensors
    on ``device``, default the card, which must then be present);
    everything else — strings in compute, joins, set ops, ordered
    windows, the long tail — runs on the numpy interpreter below, with
    the per-node fallback reasons recorded in :func:`last_dispatch`.

    ``views``: a ``core.sql_views.ViewRegistry`` — when a registered
    materialized view matches the plan's fingerprint and is fresh (its
    delta-maintained state covers exactly the snapshot's rows), the query
    is answered from the view instead of re-executing over history (route
    ``"view"``; ``sql.view.{hit,miss}`` counters; a view that fails to
    serve counts ``sql.view.serve_errors`` and the executors answer).
    Only ``mode="auto"`` consults views — "interpret"/"compile" force a
    real recompute, which is what the parity harnesses compare against.

    ``mode``: "auto" (default) picks per the plan; "interpret" forces the
    numpy interpreter; "compile" requires the compiled path and raises
    :class:`SqlCompileUnsupported` when the plan has fallback nodes.

    With a tracer installed the whole dispatch runs under an
    ``sql.query`` span carrying the route taken and the plan fingerprint
    — the link between a streaming batch's trace and the fit it feeds.
    """
    sp = _trace.span("sql.query")
    with sp:
        out = _execute_dispatched(query, resolve_table, mode, views, device)
        if sp.trace_id is not None:
            d = last_dispatch()
            if d is not None and d.query == query:
                sp.note("route", d.route)
                if d.fingerprint is not None:
                    sp.note("fingerprint", d.fingerprint)
        return out


def _source_pruned(plan) -> Table:
    """The compiled scan's source: the plan's pinned snapshot, or its
    segment-pruned twin when the snapshot came from an unbounded table
    whose sealed zone maps prove some segments cannot satisfy the WHERE
    (``core/segments.py``, data skipping).  Pruning is conservative — a
    pruned segment holds no row the filter accepts — so the result rows
    and their order are identical.  No filter or no origin scans the full
    snapshot; so does a prune that fails, counted in
    ``table.prune_errors`` and logged."""
    if plan.filter is None:
        return plan.source
    origin = getattr(plan.source, "_unbounded_origin", None)
    if origin is None:
        return plan.source
    try:
        pruned, _stats = origin.scan_pruned(getattr(plan.source, "_origin_upto", None),
                                            plan.filter)
    except Exception as e:  # pruning is an optimization, never a risk
        from ..utils.logging import get_logger

        _global_registry().inc("table.prune_errors")
        get_logger("sql").warning(
            "segment pruning failed; scanning the whole snapshot", error=repr(e))
        return plan.source
    if pruned is None:
        # every batch pruned: an empty slice of the snapshot keeps the
        # derived-column schema the lowered signature was typed against
        return plan.source.mask(np.zeros(len(plan.source), dtype=bool))
    return pruned


def _execute_dispatched(query: str, resolve_table, mode: str, views=None,
                        device=None) -> Table:
    if mode not in ("auto", "interpret", "compile"):
        raise ValueError(f"execute mode must be auto|interpret|compile, got {mode!r}")
    q = parse(query)
    reasons: tuple = ()
    if mode != "interpret" and (_compile_enabled() or mode == "compile"):
        # outside the fallback below: without a card the entry point
        # raises, it does not quietly run the interpreter
        dev = resolve_device(device)
        plan = None
        if isinstance(q, _Query):
            from .sql_plan import plan_query

            plan = plan_query(q, resolve_table)
        if views is not None and mode == "auto" and plan is not None and plan.fully_supported:
            try:
                served = views.serve_for(plan)
            except Exception as e:  # the compiled branch's contract: a
                # view-layer runtime failure (corrupt persisted state, a
                # rotten segment) degrades to the real executors, visibly
                from ..utils.logging import get_logger

                served = None
                _global_registry().inc("sql.view.serve_errors")
                get_logger("sql").warning(
                    "materialized-view serve failed; falling through to "
                    "the compiled/interpreter path", error=repr(e))
            if served is not None:
                record_dispatch(query, "view", (), plan.fingerprint)
                return served
        if plan is not None and plan.fully_supported:
            from .sql_compile import run_plan

            try:
                # plan.source, NOT resolve_table(...) again: re-resolving
                # could hand the kernel a DIFFERENT snapshot (a streaming
                # commit between plan and run) whose dtypes no longer
                # match the lowered signature.  _source_pruned may swap
                # in the segment-pruned twin of that same snapshot, which
                # is provably filter-equivalent.
                out = run_plan(plan, _source_pruned(plan), device=dev)
            except Exception as e:  # defensive: a compiled-path runtime
                # failure must degrade to the interpreter, visibly (the
                # dispatch log records it), never take the query down
                record_dispatch(
                    query, "interpreter",
                    (("compiled", f"runtime fallback: {e}"),),
                    plan.fingerprint,
                )
                if mode == "compile":
                    raise
                return (
                    _execute_union(q, resolve_table)
                    if isinstance(q, _Union)
                    else _execute_query(q, resolve_table)
                )
            record_dispatch(query, "compiled", (), plan.fingerprint)
            return out
        if plan is not None:
            reasons = tuple(plan.fallback_reasons())
        elif isinstance(q, _Union):
            reasons = (REASON_SETOP,)
        else:
            reasons = (REASON_JOIN_SUBQUERY,)
        if mode == "compile":
            raise SqlCompileUnsupported(query, reasons)
    record_dispatch(query, "interpreter", reasons)
    if isinstance(q, _Union):
        return _execute_union(q, resolve_table)
    return _execute_query(q, resolve_table)


def _union_kind(col: np.ndarray) -> str:
    """Type-compat class for UNION columns: string-like, datetime,
    timedelta, numeric — np.concatenate across classes would either
    silently stringify or raise an obscure DTypePromotionError."""
    k = col.dtype.kind
    if k in "USO":
        return "string"
    if k == "M":
        return "timestamp"
    if k == "m":
        return "interval"
    return "numeric"


def _null_aware_sort_idx(vals: np.ndarray, desc: bool) -> np.ndarray:
    """Stable ASC argsort with Spark's null placement (nulls FIRST on
    ASC; DESC falls out of reversing) — the one copy shared by the
    single-select ORDER BY and the union tail."""
    nm = _null_mask(vals)
    if nm.any():
        nonnull = np.flatnonzero(~nm)
        idx = np.concatenate(
            [
                np.flatnonzero(nm),
                nonnull[np.argsort(vals[nonnull], kind="stable")],
            ]
        )
    else:
        idx = np.argsort(vals, kind="stable")
    return idx[::-1] if desc else idx


def _lower_insub(cond, resolve_table):
    """Materialize ``IN (SELECT …)`` predicates: run each subquery once
    (it must project exactly one column), dedupe its values, and rewrite
    the node to the 3VL set form so :func:`_eval_cond3` needs no table
    resolver."""
    if cond is None:
        return None
    kind = cond[0]
    if kind in ("and", "or"):
        return (
            kind,
            _lower_insub(cond[1], resolve_table),
            _lower_insub(cond[2], resolve_table),
        )
    if kind == "not":
        return ("not", _lower_insub(cond[1], resolve_table))
    if kind in ("insub", "notinsub"):
        sub = _resolve_source(cond[2], resolve_table)
        cols = list(sub.columns)
        if len(cols) != 1:
            raise ValueError(
                f"SQL: IN (SELECT …) subquery must project exactly one "
                f"column, got {len(cols)}"
            )
        vals = sub.column(cols[0])
        null = _null_mask(vals)
        uniq = np.unique(vals[~null])
        return (
            "in3" if kind == "insub" else "notin3",
            cond[1],
            uniq,
            bool(null.any()),
        )
    return cond


def _suffix_end(last_flags: np.ndarray, n: int) -> np.ndarray:
    """Per-row index of the enclosing segment's END, from last-of-segment
    booleans — the one copy of the reversed minimum-accumulate idiom the
    window paths (tie blocks, partitions) share."""
    if n == 0:
        return np.empty(0, np.int64)
    return np.minimum.accumulate(
        np.where(last_flags, np.arange(n), n)[::-1]
    )[::-1]


def _window_column(
    getcol, n: int, item: "_SelectItem", cache: dict | None = None
) -> np.ndarray:
    """One windowed select item → a full-length column.

    Frames follow Spark defaults: no ORDER BY = the whole partition;
    with ORDER BY = RANGE UNBOUNDED PRECEDING .. CURRENT ROW (ties share
    the value at their block's last row).  Ranking functions require
    ORDER BY.  Null ordering matches the engine's sorts (ASC nulls
    first, DESC nulls last)."""
    part, order = item.window
    e = item.expr
    cache = {} if cache is None else cache
    if ("inv", part) in cache:
        inv = cache[("inv", part)]
    else:
        inv = (
            np.unique(
                _row_codes([getcol(p) for p in part]), return_inverse=True
            )[1]
            if part
            else np.zeros(n, np.int64)
        )
        cache[("inv", part)] = inv
    if e[0] == "agg":
        m = _AGG_REF.match(e[1])
        agg, c = m.groups()
        x_raw = np.ones(n, np.float64) if c == "*" else getcol(c)
        xnull = np.zeros(n, bool) if c == "*" else _null_mask(x_raw)
    else:
        # row_number | rank | dense_rank | lag | lead | ntile |
        # first_value | last_value
        agg = "ntile" if e[0] == "ntilefn" else e[1]
        if order is None and e[0] != "edgefn":
            # FIRST/LAST_VALUE work on the whole-partition frame; the
            # rank/shift/ntile functions are meaningless unordered
            raise ValueError(
                f"SQL: {agg.upper()}() requires ORDER BY in its window"
            )

    if order is None:
        # whole-partition frame: grouped aggregate broadcast to rows —
        # the RAW column feeds _grouped_aggregate so datetime min/max and
        # string min/max keep their dtype (a float64 pre-cast would turn
        # timestamps into raw nanosecond floats)
        order_idx = np.argsort(inv, kind="stable")
        sorted_inv = inv[order_idx]
        if e[0] == "edgefn":
            # unordered FIRST/LAST_VALUE = the partition's first/last row
            # in stable source order (Spark: nondeterministic-but-legal)
            src_s = getcol(e[2])[order_idx]
            new_p = (
                np.r_[True, sorted_inv[1:] != sorted_inv[:-1]]
                if n else np.empty(0, bool)
            )
            if agg == "first_value":
                pick = np.maximum.accumulate(np.where(new_p, np.arange(n), 0))
            else:
                last_p = (
                    np.r_[sorted_inv[1:] != sorted_inv[:-1], True]
                    if n else np.empty(0, bool)
                )
                pick = _suffix_end(last_p, n)
            out = np.empty(n, src_s.dtype)
            out[order_idx] = src_s[pick]
            return out
        starts = (
            np.r_[0, np.flatnonzero(np.diff(sorted_inv)) + 1]
            if n
            else np.empty((0,), np.int64)
        )
        per_group = _grouped_aggregate(np.asarray(x_raw), agg, starts, order_idx)
        # n == 0 indexes an empty per_group with an empty inv — keeping
        # the aggregate's dtype (COUNT stays int64 on an empty result;
        # a literal np.empty((0,)) would silently flip it to float64,
        # fuzz-harness finding)
        return np.asarray(per_group)[inv]

    spec_key = ("sort", part, order)
    if spec_key in cache:
        sort_idx, p_s, k_s, new_part, part_start = cache[spec_key]
    else:
        ocol, odesc = order
        ovals = getcol(ocol)
        onull = _null_mask(ovals)
        # VALUE-ordered rank codes (NOT _group_codes, whose object-column
        # factorization is first-appearance order): np.unique over the
        # non-null values sorts, searchsorted ranks; nulls key first on
        # ASC, last on DESC (the engine's sort convention)
        codes = np.zeros(n, np.int64)
        if n and (~onull).any():
            vv = ovals[~onull]
            uniq = np.unique(vv)
            codes[~onull] = np.searchsorted(uniq, vv)
        big = np.int64(n + 2)
        okey = (
            np.where(onull, big, -codes)
            if odesc
            else np.where(onull, -1, codes)
        )
        sort_idx = np.lexsort((okey, inv))          # partition-major
        p_s, k_s = inv[sort_idx], okey[sort_idx]
        new_part = (
            np.r_[True, p_s[1:] != p_s[:-1]] if n else np.empty(0, bool)
        )
        part_start = np.maximum.accumulate(np.where(new_part, np.arange(n), 0))
        cache[spec_key] = (sort_idx, p_s, k_s, new_part, part_start)
    if agg in ("first_value", "last_value"):
        src = getcol(e[2])
        src_s = src[sort_idx]
        if agg == "first_value":
            # default RANGE frame starts at the partition start
            out_s = src_s[part_start]
        else:
            # Spark's famous default-frame gotcha: LAST_VALUE over
            # RANGE … CURRENT ROW is the value at the current TIE
            # block's end, not the partition end
            last_of_block = (
                np.r_[(p_s[1:] != p_s[:-1]) | (k_s[1:] != k_s[:-1]), True]
                if n
                else np.empty(0, bool)
            )
            out_s = src_s[_suffix_end(last_of_block, n)]
    elif agg == "ntile":
        k_tiles = int(e[1])
        last_of_part = (
            np.r_[p_s[1:] != p_s[:-1], True] if n else np.empty(0, bool)
        )
        part_end = _suffix_end(last_of_part, n)
        size = part_end - part_start + 1
        pos = np.arange(n) - part_start
        q, r = size // k_tiles, size % k_tiles
        # the first r tiles carry q+1 rows (SQL NTILE distribution)
        cut = r * (q + 1)
        with np.errstate(divide="ignore", invalid="ignore"):
            out_s = np.where(
                q == 0,
                pos + 1.0,
                np.where(
                    pos < cut,
                    pos // np.maximum(q + 1, 1) + 1.0,
                    r + (pos - cut) // np.maximum(q, 1) + 1.0,
                ),
            )
    elif agg in ("lag", "lead"):
        # shift within partition along the window order; out-of-partition
        # offsets are NULL (Spark's default, no explicit default value)
        src = getcol(e[2])
        k = int(e[3]) * (1 if agg == "lag" else -1)
        src_s = src[sort_idx]
        idx = np.arange(n) - k
        valid = (idx >= 0) & (idx < n)
        idx_c = np.clip(idx, 0, max(n - 1, 0))
        same_part = valid & (p_s[idx_c] == p_s)
        if src.dtype.kind == "M":
            out_s = np.where(
                same_part, src_s[idx_c], np.datetime64("NaT")
            )
        elif src.dtype.kind == "m":
            out_s = np.where(
                same_part, src_s[idx_c], np.timedelta64("NaT")
            )
        elif src.dtype.kind in "USO":
            out_s = np.empty(n, object)
            out_s[:] = None
            out_s[same_part] = src_s[idx_c][same_part]
        else:
            out_s = np.where(
                same_part, np.asarray(src_s, np.float64)[idx_c], np.nan
            )
    elif agg == "row_number":
        out_s = np.arange(n) - part_start + 1.0
    elif agg in ("rank", "dense_rank"):
        new_block = new_part | np.r_[True, k_s[1:] != k_s[:-1]] if n else (
            np.empty(0, bool)
        )
        block_start = np.maximum.accumulate(np.where(new_block, np.arange(n), 0))
        if agg == "rank":
            out_s = block_start - part_start + 1.0
        else:
            blk_ord = np.cumsum(new_block & ~new_part)
            part_blk0 = np.maximum.accumulate(np.where(new_part, blk_ord, 0))
            out_s = blk_ord - part_blk0 + 1.0
    elif agg in ("sum", "avg", "count"):
        if agg == "count":
            x_s = np.zeros(n, np.float64)
        else:
            if not np.issubdtype(np.asarray(x_raw).dtype, np.number):
                raise ValueError(
                    f"SQL: running {agg.upper()} needs a numeric column"
                )
            x_s = np.where(xnull, 0.0, np.asarray(x_raw, np.float64))[sort_idx]
        c_s = (~xnull).astype(np.float64)[sort_idx]
        csum, ccnt = np.cumsum(x_s), np.cumsum(c_s)
        base_sum = np.where(part_start > 0, csum[part_start - 1], 0.0)
        base_cnt = np.where(part_start > 0, ccnt[part_start - 1], 0.0)
        run_sum, run_cnt = csum - base_sum, ccnt - base_cnt
        # RANGE frame: ties share the value at their block's LAST row —
        # block_end[i] = the next index ≥ i where a tie block closes
        last_of_block = (
            np.r_[(p_s[1:] != p_s[:-1]) | (k_s[1:] != k_s[:-1]), True]
            if n
            else np.empty(0, bool)
        )
        block_end = _suffix_end(last_of_block, n)
        run_sum, run_cnt = run_sum[block_end], run_cnt[block_end]
        if agg == "count":
            out_s = run_cnt
        elif agg == "sum":
            out_s = np.where(run_cnt > 0, run_sum, np.nan)
        else:
            out_s = np.where(run_cnt > 0, run_sum / np.maximum(run_cnt, 1), np.nan)
    else:
        raise ValueError(
            f"SQL: running {agg.upper()} over an ordered window is not "
            "supported (whole-partition frames support every aggregate — "
            "drop the window ORDER BY)"
        )
    out = np.empty(n, np.asarray(out_s).dtype)
    out[sort_idx] = out_s
    return out


def _resolve_source(ref, resolve_table) -> Table:
    """A FROM/JOIN source: a table name (string) resolved by the caller,
    or a derived-table query node executed recursively.  A derived
    table's inner join qualifiers are STRIPPED at the boundary (Spark's
    scoping: inner aliases are invisible outside; the outer query sees
    base names it may re-qualify with ITS alias)."""
    if isinstance(ref, str):
        return resolve_table(ref)
    t = (
        _execute_union(ref, resolve_table)
        if isinstance(ref, _Union)
        else _execute_query(ref, resolve_table)
    )
    # expression-derived names ("percentile(v, 0.5)") may contain dots
    # that are NOT qualifiers — only plain identifier columns strip
    renames = {
        c: (c.split(".")[-1] if "(" not in c else c) for c in t.columns
    }
    if len(set(renames.values())) != len(renames):
        dup = [b for b in set(renames.values())
               if sum(1 for v in renames.values() if v == b) > 1][0]
        raise ValueError(
            f"SQL: derived table exposes duplicate column {dup!r} after "
            "dropping inner qualifiers — alias one side in the subquery's "
            "select list"
        )
    if any(k != v for k, v in renames.items()):
        t = Table.from_dict({renames[c]: t.column(c) for c in t.columns})
    return t


def _set_combine(lt: Table, rt: Table, op: str) -> Table:
    """One left-fold step of a set-operation chain: positional column
    alignment (names from the left side), the string/timestamp/interval/
    numeric type guard, then the op.  INTERSECT/EXCEPT return DISTINCT
    left rows by set membership on shared row codes (standard SQL)."""
    l_cols, r_cols = list(lt.columns), list(rt.columns)
    if len(l_cols) != len(r_cols):
        raise ValueError(
            f"SQL: set-operation branches have {len(l_cols)} and "
            f"{len(r_cols)} columns — they must match"
        )
    combined: dict[str, np.ndarray] = {}
    for j, name in enumerate(l_cols):
        a, b = lt.column(name), rt.column(r_cols[j])
        ka, kb = _union_kind(a), _union_kind(b)
        if ka != kb:
            raise ValueError(
                f"SQL: set-operation column {name!r} mixes {ka} and {kb} "
                "branches"
            )
        combined[name] = np.concatenate([a, b])
    t = Table.from_dict(combined)
    if op == "union_all":
        return t
    if op == "union":
        return _distinct_rows(t)
    # INTERSECT / EXCEPT: shared row codes over the combined table make
    # left and right rows comparable (per-table codes would not be)
    if not combined:
        return lt
    packed = _row_codes([t.column(c) for c in t.columns])
    _, inv = np.unique(packed, return_inverse=True)
    n_l = len(lt)
    member = np.isin(inv[:n_l], inv[n_l:])
    keep = member if op == "intersect" else ~member
    return _distinct_rows(lt.mask(keep))


def _execute_union(u: "_Union", resolve_table) -> Table:
    def run(node):
        return (
            _execute_union(node, resolve_table)
            if isinstance(node, _Union)
            else _execute_query(node, resolve_table)
        )

    t = run(u.queries[0])
    for op, node in zip(u.ops, u.queries[1:]):
        t = _set_combine(t, run(node), op)
    if u.order is not None:
        # validate BEFORE any emptiness shortcut — an unknown ORDER BY
        # column must raise even on a zero-row result (Spark analysis)
        col, desc = u.order
        try:
            col = _resolve_name(t, col, set())
        except ValueError as e:
            if "ambiguous" in str(e):
                raise  # keep the qualify-it diagnostic
            raise ValueError(
                f"SQL: ORDER BY column {u.order[0]!r} is not in the union "
                "result"
            ) from None
        t = t.mask(_null_aware_sort_idx(t.column(col), desc))
    if u.limit is not None:
        t = t.mask(np.arange(min(u.limit, len(t))))
    return t


def _execute_query(q: "_Query", resolve_table) -> Table:
    if q.where is not None or q.having is not None:
        # uncorrelated IN (SELECT …) predicates materialize up front
        q = _Query(
            q.items, q.distinct, q.table, q.joins,
            _lower_insub(q.where, resolve_table), q.group,
            _lower_insub(q.having, resolve_table), q.order, q.limit,
        )
    items = q.items
    if items is not None:
        # duplicate output names would silently shadow each other in the
        # projection dict — SELECT e.id, h.id needs an AS on one of them
        seen: set[str] = set()
        for it in items:
            if it.alias in seen:
                raise ValueError(
                    f"SQL: duplicate output column {it.alias!r}; "
                    "disambiguate with AS"
                )
            seen.add(it.alias)
    base_name, base_alias = q.table
    t: Table = _resolve_source(base_name, resolve_table)
    aliases = {base_alias}

    if q.joins:
        # qualify the base table once; each join qualifies its right side
        t = Table.from_dict({f"{base_alias}.{c}": t.column(c) for c in t.columns})
        for kind, (r_name, r_alias), lk_name, rk_name in q.joins:
            if r_alias in aliases:
                raise ValueError(f"SQL: duplicate table alias {r_alias!r}")
            rt = _resolve_source(r_name, resolve_table)
            if kind == "cross":
                n_l, n_r = len(t), len(rt)
                li = np.repeat(np.arange(n_l), n_r)
                ri = np.tile(np.arange(n_r), n_l)
                t = Table.from_dict(
                    {
                        **{c: t.column(c)[li] for c in t.columns},
                        **{
                            f"{r_alias}.{c}": rt.column(c)[ri]
                            for c in rt.columns
                        },
                    }
                )
                aliases.add(r_alias)
                continue

            def right_col(name: str):
                """Resolve a key reference against the NEW right table."""
                if "." in name:
                    qual, base = name.split(".", 1)
                    return rt.column(base) if (
                        qual == r_alias and base in rt.columns
                    ) else None
                return rt.column(name) if name in rt.columns else None

            def left_col(name: str):
                try:
                    return t.column(_resolve_name(t, name, aliases))
                except ValueError:
                    return None

            # the ON keys may be written in either order (a.k = b.k or
            # b.k = a.k): one side must resolve in the joined-so-far
            # table, the other in the new right table
            lk, rk = left_col(lk_name), right_col(rk_name)
            if lk is None or rk is None:
                lk, rk = left_col(rk_name), right_col(lk_name)
            if lk is None or rk is None:
                shown = r_name if isinstance(r_name, str) else f"(subquery) {r_alias}"
                raise ValueError(
                    f"SQL: JOIN ON must compare a joined column with a "
                    f"column of {shown!r}; got {lk_name!r} = {rk_name!r}"
                )
            t = _equi_join(t, rt, lk, np.asarray(rk), kind, r_alias)
            aliases.add(r_alias)

    def getcol(name: str) -> np.ndarray:
        return t.column(_resolve_name(t, name, aliases))

    if q.where is not None:
        t = t.mask(_eval_cond(getcol, q.where))

    windowed = [it for it in (items or []) if it.window is not None]
    if windowed:
        if q.group:
            raise ValueError(
                "SQL: window functions cannot mix with GROUP BY — compute "
                "the windows in a FROM subquery"
            )
        for it in items:
            if it.window is None and (
                it.agg is not None or _expr_has_agg(it.expr)
            ):
                raise ValueError(
                    f"SQL: plain aggregate {it.alias!r} cannot mix with "
                    "window functions — give it an OVER () window"
                )
        # windows compute AFTER the WHERE mask (SQL logical order), then
        # become HIDDEN columns (sentinel-named, so star-plus expansion
        # cannot collide with them) that the rewritten select items and
        # ORDER BY reference by alias
        n_rows = len(t)
        merged = {c: t.column(c) for c in t.columns}
        rewritten = []
        win_cache: dict = {}  # shared partition codes + sorts per spec
        for it in items:
            if it.window is None:
                rewritten.append(it)
                continue
            hidden = f"__win{len(merged)}__"
            merged[hidden] = _window_column(getcol, n_rows, it, win_cache)
            rewritten.append(_SelectItem(None, hidden, it.alias))
        t = Table.from_dict(merged)
        items = rewritten

    if q.group:
        if items is None:
            raise ValueError("SQL: GROUP BY requires an explicit select list")
        # Spark's groupByOrdinal: GROUP BY 1 refers to the FIRST select
        # item (any other literal key would silently collapse every row
        # into one constant group)
        resolved_group = []
        for g in q.group:
            if isinstance(g, str) or g[0] != "lit":
                resolved_group.append(g)
                continue
            n_ord = g[1]
            if not isinstance(n_ord, int):
                # a non-integer literal key was never an ordinal — Spark
                # groups by the constant (one group); match it rather
                # than mislabel the literal in an ordinal error
                resolved_group.append(g)
                continue
            if not 1 <= n_ord <= len(items):
                raise ValueError(
                    f"SQL: GROUP BY ordinal {n_ord} must be in "
                    f"1..{len(items)}"
                )
            it = items[n_ord - 1]
            if it.agg is not None or (it.expr is not None and _expr_has_agg(it.expr)):
                raise ValueError(
                    f"SQL: GROUP BY ordinal {n_ord} refers to an aggregate"
                )
            if it.col == "*":
                raise ValueError("SQL: GROUP BY ordinal cannot refer to *")
            resolved_group.append(it.col if it.expr is None else it.expr)
        q = _Query(
            items, q.distinct, q.table, q.joins, q.where, resolved_group,
            q.having, q.order, q.limit,
        )
        # GROUP BY items: plain names (strings) and/or expression ASTs
        # (GROUP BY CASE … END — Spark groups by arbitrary expressions;
        # a select item structurally equal to a key expression reads the
        # key's per-group value, Spark's syntactic-match rule)
        name_keys = [g for g in q.group if isinstance(g, str)]
        expr_key_list: list[tuple] = [
            g for g in q.group if not isinstance(g, str)
        ]
        group_cols = {g: _resolve_name(t, g, aliases) for g in name_keys}

        def _group_expr_index(e) -> int | None:
            for i, ast in enumerate(expr_key_list):
                if ast == e:
                    return i
            return None

        for it in items:
            if it.col == "*":
                raise ValueError("SQL: SELECT * cannot mix with GROUP BY")
            if it.expr is not None:
                if _group_expr_index(it.expr) is not None:
                    continue  # this select item IS a group-key expression
                for c in _expr_cols(it.expr):
                    if not (
                        c in name_keys
                        or _resolve_name(t, c, aliases) in group_cols.values()
                    ):
                        raise ValueError(
                            f"SQL: column {c!r} inside an expression must "
                            "appear in GROUP BY or an aggregate"
                        )
                continue
            if it.agg is None and not (
                it.col in name_keys
                or _resolve_name(t, it.col, aliases) in group_cols.values()
            ):
                raise ValueError(
                    f"SQL: column {it.col!r} must appear in GROUP BY or an "
                    "aggregate"
                )
        expr_key_arrays = []
        for g in expr_key_list:
            arr = _eval_expr(getcol, g)
            expr_key_arrays.append(
                np.full(len(t), arr) if np.ndim(arr) == 0 else np.asarray(arr)
            )
        keys = [t.column(c) for c in group_cols.values()] + expr_key_arrays
        # lexicographic group ids via np.unique over a structured view of
        # per-column integer codes — codes (not raw values) so every null
        # (NaN/NaT) lands in ONE group, Spark's GROUP BY rule
        packed = _row_codes(keys)
        uniq, inv = np.unique(packed, return_inverse=True)
        order_idx = np.argsort(inv, kind="stable")
        sorted_inv = inv[order_idx]
        # zero groups (empty source / WHERE matched nothing) → empty result
        starts = (
            np.r_[0, np.flatnonzero(np.diff(sorted_inv)) + 1]
            if len(uniq)
            else np.empty((0,), np.int64)
        )
        counts = np.bincount(inv, minlength=len(uniq))
        first_row = order_idx[starts]             # one representative/group

        def per_group_atom(name: str) -> np.ndarray:
            """Expression atom in grouped context: aggregate spelling →
            on-demand aggregate; group key → its per-group value."""
            m = _AGG_REF.match(name)
            if m:
                agg, c = m.groups()
                if c == "*":
                    return counts.astype(np.int64)
                return _grouped_aggregate(getcol(c), agg, starts, order_idx)
            return getcol(name)[first_row]

        def grouped_aggex(node) -> np.ndarray:
            # aggregate over an arbitrary row expression: evaluate the
            # inner expr against SOURCE rows, then the usual reduceat
            # (or the per-group percentile loop for "pct" nodes)
            inner = node[1] if node[0] == "pct" else node[2]
            vals = _eval_expr(getcol, inner)
            if np.ndim(vals) == 0:
                vals = np.full(len(t), vals)
            vals = np.asarray(vals)
            if node[0] == "pct":
                return _grouped_percentile(vals, node[2], starts, order_idx)
            return _grouped_aggregate(vals, node[1], starts, order_idx)

        cols: dict[str, Any] = {}
        for it in items:
            if it.expr is not None:
                gi = _group_expr_index(it.expr)
                if gi is not None:
                    cols[it.alias] = expr_key_arrays[gi][first_row]
                    continue
                low, extra = _lower_aggex(it.expr, grouped_aggex)
                v = _eval_expr(
                    lambda n: extra[n] if n in extra else per_group_atom(n),
                    low,
                )
                cols[it.alias] = (
                    np.full(len(first_row), v) if np.ndim(v) == 0 else v
                )
            elif it.agg is None:
                cols[it.alias] = getcol(it.col)[first_row]
            elif it.col is None:  # COUNT(*)
                cols[it.alias] = counts.astype(np.int64)
            else:
                cols[it.alias] = _grouped_aggregate(
                    getcol(it.col), it.agg, starts, order_idx
                )
        # HAVING / ORDER BY may reference select aliases, canonical
        # agg(col) spellings, qualified group keys, or aggregates that
        # were never selected (computed on demand from the same
        # sort/starts — no extra data pass)
        canonical = {
            f"{it.agg}({it.col or '*'})": it.alias
            for it in items
            if it.agg is not None
        }
        sel_by_col = {
            it.col: it.alias
            for it in items
            if it.agg is None and it.col is not None
        }

        def grouped_col(name: str, what: str) -> np.ndarray:
            if name in cols:
                return cols[name]
            if name in canonical:
                return cols[canonical[name]]
            if name in sel_by_col:          # e.g. ORDER BY h.beds
                return cols[sel_by_col[name]]
            m = _AGG_REF.match(name)
            if m:
                agg, c = m.groups()
                if c == "*":
                    return counts.astype(np.int64)
                return _grouped_aggregate(getcol(c), agg, starts, order_idx)
            raise ValueError(
                f"SQL: {what} reference {name!r} is neither an output "
                "column nor an aggregate"
            )

        # resolve the ORDER BY column BEFORE the HAVING mask (on-demand
        # aggregates are pre-mask length) and carry it as a hidden column
        order_hidden = None
        if q.order is not None and q.order[0] not in cols:
            order_hidden = "__order_by__"
            cols[order_hidden] = grouped_col(q.order[0], "ORDER BY")
        grouped = Table.from_dict(cols)
        if q.having is not None:
            grouped = grouped.mask(
                _eval_cond(lambda n: grouped_col(n, "HAVING"), q.having)
            )
        t = grouped
        if order_hidden is not None:
            q = _Query(
                items, q.distinct, q.table, q.joins, q.where, q.group,
                None, (order_hidden, q.order[1]), q.limit,
            )
        items = None  # already projected to aliases
        aliases = set()
    elif items is not None and any(
        it.agg is not None or _expr_has_agg(it.expr) for it in items
    ):
        # whole-table aggregates collapse to one row — a bare column in the
        # same list has no single value (Spark requires GROUP BY too)
        for it in items:
            if it.col == "*":
                raise ValueError("SQL: SELECT * cannot mix with aggregates")
            if it.expr is not None:
                bare = _expr_cols(it.expr)
                if bare:
                    raise ValueError(
                        f"SQL: column {bare[0]!r} cannot mix with "
                        "aggregates without GROUP BY"
                    )
                continue
            if it.agg is None:
                raise ValueError(
                    f"SQL: column {it.col!r} cannot mix with aggregates "
                    "without GROUP BY"
                )
        src_t, src_getcol = t, getcol
        agg_canonical = {
            f"{it.agg}({it.col or '*'})": it.alias
            for it in items
            if it.agg is not None
        }
        def scalar_atom(name: str):
            m = _AGG_REF.match(name)
            if not m:
                raise ValueError(f"SQL: {name!r} is not an aggregate")
            agg, c = m.groups()
            # count(*) stays integer so its dtype matches the bare
            # projection path; arithmetic contexts promote as needed
            return len(t) if c == "*" else _aggregate(getcol(c), agg)

        def scalar_aggex(node):
            inner = node[1] if node[0] == "pct" else node[2]
            vals = _eval_expr(getcol, inner)
            if np.ndim(vals) == 0:
                vals = np.full(len(t), vals)
            vals = np.asarray(vals)
            if node[0] == "pct":
                _require_pct_numeric(vals)
                ok = vals[~_null_mask(vals)]
                return (
                    float(np.percentile(ok, node[2] * 100.0))
                    if ok.size else np.nan
                )
            return _aggregate(vals, node[1])

        out_cols: dict[str, Any] = {}
        for it in items:
            if it.expr is not None:
                low, extra = _lower_aggex(it.expr, scalar_aggex)
                out_cols[it.alias] = np.asarray(
                    [
                        _eval_expr(
                            lambda n: extra[n] if n in extra else scalar_atom(n),
                            low,
                        )
                    ]
                )
            else:
                out_cols[it.alias] = np.asarray(
                    [len(t) if it.col is None else _aggregate(getcol(it.col), it.agg)]
                )
        t = Table.from_dict(out_cols)
        if q.having is not None:
            # no GROUP BY: the whole table is one group — HAVING filters
            # the single output row (Spark semantics)
            def scalar_col(name: str) -> np.ndarray:
                if name in t.columns:
                    return t.column(name)
                if name in agg_canonical:
                    return t.column(agg_canonical[name])
                m = _AGG_REF.match(name)
                if m:
                    agg, c = m.groups()
                    v = (
                        len(src_t)
                        if c == "*"
                        else _aggregate(src_getcol(c), agg)
                    )
                    return np.asarray([v])
                raise ValueError(
                    f"SQL: HAVING reference {name!r} is neither an output "
                    "column nor an aggregate"
                )

            t = t.mask(_eval_cond(scalar_col, q.having))
        if q.order is not None and q.order[0] not in t.columns:
            # ORDER BY on a canonical aggregate spelling over the single
            # output row: validate the reference, then drop the (no-op)
            # ordering of one row
            name = q.order[0]
            if name not in agg_canonical and not _AGG_REF.match(name):
                raise ValueError(
                    f"SQL: ORDER BY column {name!r} is not in the table"
                )
            q = _Query(
                items, q.distinct, q.table, q.joins, q.where, q.group,
                None, None, q.limit,
            )
        items = None  # already projected
        aliases = set()
    elif q.having is not None:
        raise ValueError("SQL: HAVING requires GROUP BY or aggregates")

    if q.order is not None and len(t) > 0:
        col, desc = q.order
        # order BEFORE projection so ORDER BY may reference any source
        # column (legal SQL); a SELECT alias resolves to its source here
        # (expression aliases evaluate their expression as the sort key),
        # and grouped results order by their output columns
        vals = None
        if col not in t.columns and items is not None:
            for it in items:
                if it.alias == col and it.expr is not None:
                    v = _eval_expr(getcol, it.expr)
                    # a constant expression sorts as a full-length column
                    # (a 0-d argsort would silently keep one row)
                    vals = (
                        np.full(len(t), v) if np.ndim(v) == 0 else np.asarray(v)
                    )
                    break
            else:
                col = {
                    it.alias: it.col for it in items if it.col is not None
                }.get(col, col)
        if vals is None:
            try:
                col = _resolve_name(t, col, aliases)
            except ValueError:
                raise ValueError(
                    f"SQL: ORDER BY column {col!r} is not in the "
                    f"{'grouped result' if q.group else 'table'}"
                ) from None
            vals = t.column(col)
        # _null_aware_sort_idx: ASC → NULLS FIRST, DESC → NULLS LAST
        # (Spark defaults; DESC falls out of reversing the ASC order)
        t = t.mask(_null_aware_sort_idx(vals, desc))  # permutes every column
    if items is not None:
        # plain projection, applied after ORDER BY so sorting may use any
        # source column; star-plus expands here, expressions evaluate
        # per row, aliases materialize
        proj: dict[str, Any] = {}
        for pos, it in enumerate(items):
            if it.col == "*":
                if pos != 0:
                    raise ValueError("SQL: * must come first in a select list")
                for c in t.columns:
                    if c.startswith("__win") and c.endswith("__"):
                        continue  # hidden window columns are not user data
                    proj[c] = t.column(c)
                continue
            if it.alias in proj:
                # an extra whose alias collides with a star-expanded base
                # column would silently shadow it (the select-list dup
                # check can't see what * expands to)
                raise ValueError(
                    f"SQL: duplicate output column {it.alias!r}; "
                    "disambiguate with AS"
                )
            if it.expr is not None:
                v = _eval_expr(getcol, it.expr)
                proj[it.alias] = np.full(len(t), v) if np.ndim(v) == 0 else v
            else:
                proj[it.alias] = t.column(_resolve_name(t, it.col, aliases))
        t = Table.from_dict(proj)
    elif "__order_by__" in t.columns:
        # drop the grouped ORDER BY carrier column
        t = Table.from_dict(
            {c: t.column(c) for c in t.columns if c != "__order_by__"}
        )
    if q.distinct:
        t = _distinct_rows(t)
    if q.limit is not None:
        t = t.limit(q.limit)
    return t

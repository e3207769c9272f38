"""Logical planner: parsed SQL AST → a typed, lowerable plan.

Layer 2 of the split engine (parse → logical plan → execution,
the Flare move, PAPERS arxiv 1703.08219).  ``plan_query`` takes one
single-table ``_Query`` AST plus the resolved source table and produces a
:class:`LogicalPlan`: every clause becomes a :class:`PlanNode` carrying
an explicit **supported / fallback** decision, and the supported subset
is *lowered* — names resolved to source columns, literals baked into the
column's comparison space (timestamps → int64 ns), expression dtypes
inferred to match the numpy interpreter's promotion rules — into
hashable tuple trees the compiled executor (``core/sql_compile.py``)
runs as torch ops over device-held columns.

The supported subset (everything else records a per-node reason and the
query runs on the numpy interpreter in ``core/sql.py``):

* single registered table, no joins / subqueries / set operations
* WHERE over numeric/timestamp columns: ``= != < <= > >=``, BETWEEN,
  IS [NOT] NULL, [NOT] IN (literals), AND/OR/NOT under SQL 3VL
* projection: ``*`` / bare columns of any type (pass-through), scalar
  expressions over numeric columns (``+ - * /``, unary minus, CASE WHEN,
  ABS, COALESCE, numeric literals)
* GROUP BY plain key columns — numeric/timestamp, and string keys via
  host-side sorted-rank dictionary codes — with COUNT(*) /
  COUNT/SUM/AVG/MIN/MAX over numeric columns; whole-table aggregates
* window functions: ``agg(col) OVER (PARTITION BY numeric/timestamp
  cols)`` — the whole-partition frame (no window ORDER BY)
* LIMIT on row-level queries (host-side slice of the materialized rows)

Fallback stays the long tail by design: strings in compute, ROUND's
Decimal HALF_UP semantics, date functions, ordered windows, HAVING,
DISTINCT, ORDER BY, joins, set ops.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from .sql_parse import _AGG_REF, _Query, _expr_has_agg

#: dtype characters the device layer understands
#: f = float64 (NaN null), i = int64 (null-free), t = timestamp as int64
#: ns (NaT sentinel), s = string/object (host-only except as a group
#: key, where the runner ships sorted-rank codes instead of the column)
_KIND_TO_CHAR = {"f": "f", "i": "i", "u": "i", "b": "i", "M": "t"}


class _Unsupported(Exception):
    """Internal: a construct outside the compiled subset (the message is
    the recorded per-node fallback reason)."""


@dataclass(frozen=True)
class PlanNode:
    op: str          # scan|filter|project|window|aggregate|sort|having|limit|distinct
    supported: bool
    reason: str = ""  # why not, when unsupported ("" otherwise)


@dataclass(frozen=True)
class LogicalPlan:
    """One single-table query, clause by clause, with lowered payloads.

    ``outputs`` (row-level): tuple of
      ``("pass", src, alias)`` — untouched source column (any dtype)
      ``("expr", lowered, alias, tchar)`` — computed numeric expression
      ``("win", agg, src|None, parts, alias, tchar)`` — whole-partition
        window aggregate broadcast back to rows
    ``outputs`` (aggregate): tuple of
      ``("key", idx, alias)`` — the idx-th group key's per-group value
      ``("count_star", alias)``
      ``("agg", agg, src, alias)`` — count/sum/avg/min/max over ``src``
    """

    table: str
    alias: str
    kind: str                      # "rowlevel" | "aggregate"
    filter: tuple | None           # lowered 3VL predicate tree
    outputs: tuple
    group_keys: tuple              # ((src, tchar), ...) aggregate only
    limit: int | None              # rowlevel host-post slice
    col_types: tuple               # ((src, tchar), ...) every col touched
    nodes: tuple
    #: the Table SNAPSHOT the plan was lowered against — executors must
    #: run against THIS instance, not re-resolve the name: a background
    #: streaming commit between plan and run could swap the snapshot
    #: (and its dtypes) out from under the lowered kernel signature
    source: Any = field(default=None, compare=False, repr=False)

    @property
    def fully_supported(self) -> bool:
        return all(n.supported for n in self.nodes)

    def fallback_reasons(self) -> list[tuple[str, str]]:
        return [(n.op, n.reason) for n in self.nodes if not n.supported]

    @property
    def fingerprint(self) -> str:
        """Stable plan identity: the lowered plan and the touched
        columns' dtypes, not the row count — equal to the JAX package's
        fingerprint of the same query over the same dtypes."""
        payload = repr(
            (
                self.kind, self.filter, self.outputs, self.group_keys,
                self.limit, self.col_types,
            )
        )
        return hashlib.sha1(payload.encode()).hexdigest()[:16]

    # the tuple the executor's evaluators read (kind, filter, outputs, keys, types)
    @property
    def kernel_sig(self) -> tuple:
        return (self.kind, self.filter, self.outputs, self.group_keys,
                self.col_types)

    def explain(self) -> list[dict]:
        """Per-clause-node view: the supported/fallback decision plus
        the **incremental** decision — ``"incremental"`` when
        a materialized view maintains this clause per committed batch,
        else a ``"full-recompute:<reason>"`` constant
        (``core/sql_views.py``'s reason-constant set)."""
        from .sql_views import incremental_decisions  # lazy: avoids cycle

        return [
            {
                "op": n.op,
                "supported": n.supported,
                "reason": n.reason,
                "incremental": d,
            }
            for n, d in zip(self.nodes, incremental_decisions(self))
        ]


def _col_char(table, name: str) -> str:
    """Device dtype char from the ACTUAL numpy dtype (schema INT columns
    may hold float64 when NaN-capable — ``Table._coerce``)."""
    return _KIND_TO_CHAR.get(table.column(name).dtype.kind, "s")


class _Lowering:
    def __init__(self, table, alias: str):
        self.table = table
        self.alias = alias
        self.touched: dict[str, str] = {}

    def resolve(self, name: str) -> str:
        t = self.table
        if name in t.columns:
            src = name
        elif "." in name:
            qual, base = name.split(".", 1)
            if qual == self.alias and base in t.columns:
                src = base
            else:
                raise _Unsupported(f"unknown column {name!r}")
        else:
            raise _Unsupported(f"unknown column {name!r}")
        self.touched[src] = _col_char(t, src)
        return src

    def numeric_col(self, name: str) -> tuple[str, str]:
        src = self.resolve(name)
        ch = self.touched[src]
        if ch not in ("i", "f"):
            raise _Unsupported(
                f"column {name!r} is not numeric (device compute covers "
                "numeric columns only)"
            )
        return src, ch

    # -------------------------------------------------------- literals
    def bake_literal(self, src: str, lit) -> int | float:
        """Literal → the column's device comparison space (mirrors the
        interpreter's ``_coerce``)."""
        ch = self.touched[src]
        if ch == "t":
            try:
                ts = np.datetime64(str(lit).replace(" ", "T"))
            except ValueError:
                raise _Unsupported(
                    f"unparseable timestamp literal {lit!r}"
                ) from None
            return int(ts.astype("datetime64[ns]").astype(np.int64))
        if isinstance(lit, str):
            try:
                return float(lit)
            except ValueError:
                raise _Unsupported(
                    f"string literal {lit!r} against numeric column {src!r}"
                ) from None
        return lit

    # ------------------------------------------------------ predicates
    def cond(self, c) -> tuple:
        kind = c[0]
        if kind in ("and", "or"):
            return (kind, self.cond(c[1]), self.cond(c[2]))
        if kind == "not":
            return ("not", self.cond(c[1]))
        if kind == "isnull":
            src = self.resolve(c[1])
            if self.touched[src] == "s":
                raise _Unsupported("IS NULL over a string column")
            return ("isnull", src)
        if kind in ("in", "notin"):
            src = self.resolve(c[1])
            if self.touched[src] == "s":
                raise _Unsupported("IN over a string column")
            vals = tuple(self.bake_literal(src, v) for v in c[2])
            return (kind, src, vals)
        if kind == "between":
            src = self.resolve(c[1])
            if self.touched[src] == "s":
                raise _Unsupported("BETWEEN over a string column")
            return (
                "between", src,
                self.bake_literal(src, c[2]), self.bake_literal(src, c[3]),
            )
        if kind == "cmp":
            src = self.resolve(c[1])
            if self.touched[src] == "s":
                raise _Unsupported("comparison over a string column")
            return ("cmp", src, c[2], self.bake_literal(src, c[3]))
        # insub/notinsub (and anything newer) stays interpreter territory
        raise _Unsupported(f"predicate {kind!r} (subqueries) in WHERE")

    # ----------------------------------------------------- expressions
    def expr(self, e) -> tuple[tuple, str]:
        """Lowered expression + inferred dtype char ("i" | "f"), matching
        numpy's promotion rules so materialized dtypes equal the
        interpreter's."""
        k = e[0]
        if k == "col":
            src, ch = self.numeric_col(e[1])
            return ("col", src), ch
        if k == "lit":
            v = e[1]
            if isinstance(v, str):
                raise _Unsupported("string literal in a computed expression")
            return ("lit", v), ("i" if isinstance(v, int) else "f")
        if k == "neg":
            le, ch = self.expr(e[1])
            return ("neg", le), ch
        if k == "bin":
            _, op, a, b = e
            la, ca = self.expr(a)
            lb, cb = self.expr(b)
            ch = "f" if (op == "/" or "f" in (ca, cb)) else "i"
            return ("bin", op, la, lb), ch
        if k == "case":
            branches, default = e[1], e[2]
            lb = []
            chars = []
            for cond, val in branches:
                lc = self.cond(cond)
                lv, ch = self.expr(val)
                lb.append((lc, lv))
                chars.append(ch)
            if default is None:
                ld = None
                ch = "f"  # implicit ELSE NULL promotes to float (NaN)
            else:
                ld, dch = self.expr(default)
                chars.append(dch)
                ch = "f" if "f" in chars else "i"
            return ("case", tuple(lb), ld), ch
        if k == "fn":
            name, args = e[1], e[2]
            if name == "abs":
                if len(args) != 1:
                    raise _Unsupported("ABS arity error (interpreter raises)")
                la, ch = self.expr(args[0])
                return ("fn", "abs", (la,)), ch
            if name == "coalesce":
                if not 1 <= len(args) <= 64:
                    raise _Unsupported(
                        "COALESCE arity error (interpreter raises)"
                    )
                lowered = [self.expr(a) for a in args]
                ch = "f" if any(c == "f" for _, c in lowered) else "i"
                return ("fn", "coalesce", tuple(a for a, _ in lowered)), ch
            raise _Unsupported(
                f"scalar function {name.upper()} (host-only semantics)"
            )
        raise _Unsupported(f"expression node {k!r}")


def plan_query(q: _Query, resolve_table) -> LogicalPlan | None:
    """AST → :class:`LogicalPlan`, or ``None`` when the query shape has
    no single-table plan at all (FROM subquery).  Joins DO get a plan —
    with an unsupported ``scan`` node — so the fallback is observable."""
    base_name, base_alias = q.table
    if not isinstance(base_name, str):
        return None
    table = resolve_table(base_name)

    low = _Lowering(table, base_alias)
    nodes: list[PlanNode] = []
    ok = True

    if q.joins:
        nodes.append(
            PlanNode("scan", False, "joins run on the interpreter")
        )
        ok = False
    else:
        nodes.append(PlanNode("scan", True))

    lowered_filter = None
    if q.where is not None:
        try:
            lowered_filter = low.cond(q.where)
            nodes.append(PlanNode("filter", True))
        except _Unsupported as e:
            nodes.append(PlanNode("filter", False, str(e)))
            ok = False

    items = q.items
    windowed = [it for it in (items or []) if it.window is not None]
    grouped = bool(q.group) or (
        items is not None
        and any(
            (it.agg is not None or _expr_has_agg_item(it))
            and it.window is None
            for it in items
        )
    )

    outputs: list[tuple] = []
    group_keys: tuple = ()
    kind = "aggregate" if grouped else "rowlevel"

    if grouped:
        try:
            group_keys, agg_outputs = _plan_aggregate(q, low)
            outputs = agg_outputs
            nodes.append(PlanNode("aggregate", True))
        except _Unsupported as e:
            nodes.append(PlanNode("aggregate", False, str(e)))
            ok = False
    else:
        try:
            outputs = _plan_projection(q, low, table)
            nodes.append(PlanNode("project", True))
            if windowed:
                nodes.append(PlanNode("window", True))
        except _Unsupported as e:
            nodes.append(
                PlanNode("window" if windowed else "project", False, str(e))
            )
            ok = False

    if q.having is not None:
        nodes.append(
            PlanNode("having", False, "HAVING runs on the interpreter")
        )
        ok = False
    if q.distinct:
        nodes.append(
            PlanNode("distinct", False, "DISTINCT runs on the interpreter")
        )
        ok = False
    if q.order is not None:
        nodes.append(
            PlanNode("sort", False, "ORDER BY runs on the interpreter")
        )
        ok = False

    limit = None
    if q.limit is not None:
        if kind == "rowlevel" and ok:
            limit = int(q.limit)
            nodes.append(PlanNode("limit", True))
        else:
            nodes.append(
                PlanNode(
                    "limit", False,
                    "LIMIT compiles only on row-level plans",
                )
            )
            ok = False

    return LogicalPlan(
        table=base_name,
        alias=base_alias,
        kind=kind,
        filter=lowered_filter if ok else None,
        outputs=tuple(outputs) if ok else (),
        group_keys=group_keys if ok else (),
        limit=limit,
        col_types=tuple(sorted(low.touched.items())),
        nodes=tuple(nodes),
        source=table,
    )


def _expr_has_agg_item(it) -> bool:
    return it.expr is not None and _expr_has_agg(it.expr)


def _plan_projection(q: _Query, low: _Lowering, table) -> list[tuple]:
    """Row-level select list → output spec (star expansion included)."""
    items = q.items
    outputs: list[tuple] = []
    if items is None:
        for c in table.schema.names:
            low.resolve(c)
            outputs.append(("pass", c, c))
        return outputs
    seen: set[str] = set()
    for pos, it in enumerate(items):
        if it.col == "*":
            if pos != 0:
                raise _Unsupported("* must come first in a select list")
            for c in table.schema.names:
                low.resolve(c)
                outputs.append(("pass", c, c))
                seen.add(c)
            continue
        if it.alias in seen:
            raise _Unsupported(f"duplicate output column {it.alias!r}")
        seen.add(it.alias)
        if it.window is not None:
            outputs.append(_plan_window_item(it, low))
            continue
        if it.expr is None:
            # bare column: pass through untouched (any dtype, strings
            # and timestamps included — no device compute needed)
            src = low.resolve(it.col)
            outputs.append(("pass", src, it.alias))
            continue
        lowered, ch = low.expr(it.expr)
        outputs.append(("expr", lowered, it.alias, ch))
    return outputs


def _plan_window_item(it, low: _Lowering) -> tuple:
    part, order = it.window
    if order is not None:
        raise _Unsupported(
            "ordered windows (running frames/ranking) run on the interpreter"
        )
    e = it.expr
    if e[0] != "agg":
        raise _Unsupported(
            f"window function {e[0]} runs on the interpreter"
        )
    agg, col = _AGG_REF.match(e[1]).groups()
    parts = []
    for p in part:
        src = low.resolve(p)
        if low.touched[src] == "s":
            raise _Unsupported("PARTITION BY over a string column")
        parts.append(src)
    if col == "*":
        if agg != "count":
            raise _Unsupported(f"{agg}(*) window")
        src, ch = None, "i"
    else:
        src, _ = low.numeric_col(col)
        ch = "i" if agg == "count" else "f"
    return ("win", agg, src, tuple(parts), it.alias, ch)


def _plan_aggregate(q: _Query, low: _Lowering) -> tuple[tuple, list[tuple]]:
    """GROUP BY / whole-table aggregate select list → (keys, outputs)."""
    items = q.items
    if items is None:
        raise _Unsupported("SELECT * with aggregates")
    keys: list[tuple[str, str]] = []
    for g in q.group:
        if not isinstance(g, str):
            raise _Unsupported(
                "GROUP BY expressions/ordinals run on the interpreter"
            )
        # string keys compile too: the runner host-encodes them to
        # sorted-rank int64 codes (sql_compile.string_group_codes), so
        # the kernel groups over codes and decodes the tiny per-group
        # result — the column itself never transfers
        src = low.resolve(g)
        keys.append((src, low.touched[src]))
    key_srcs = [s for s, _ in keys]

    outputs: list[tuple] = []
    seen: set[str] = set()
    for it in items:
        if it.alias in seen:
            raise _Unsupported(f"duplicate output column {it.alias!r}")
        seen.add(it.alias)
        if it.window is not None or it.expr is not None:
            raise _Unsupported(
                "expressions over aggregates run on the interpreter"
            )
        if it.agg is None:
            src = low.resolve(it.col)
            if src not in key_srcs:
                raise _Unsupported(
                    f"column {it.col!r} must appear in GROUP BY"
                )
            outputs.append(("key", key_srcs.index(src), it.alias))
            continue
        if it.col is None:
            if it.agg != "count":
                raise _Unsupported(f"{it.agg}(*)")
            outputs.append(("count_star", it.alias))
            continue
        src = low.resolve(it.col)
        ch = low.touched[src]
        if it.agg == "count":
            if ch == "s":
                raise _Unsupported("COUNT over a string column")
        elif ch not in ("i", "f"):
            raise _Unsupported(
                f"{it.agg.upper()} over a non-numeric column {it.col!r}"
            )
        outputs.append(("agg", it.agg, src, it.alias))
    return tuple(keys), outputs

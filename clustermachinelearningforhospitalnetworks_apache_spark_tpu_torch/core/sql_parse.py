"""SQL front end: tokenizer, recursive-descent parser, and AST.

Layer 1 of the split engine (parse -> logical plan -> execution,
the Flare move): this module turns a query string into the engine's AST
(:class:`_Query` / :class:`_Union` trees of tuple-shaped expression and
predicate nodes) and owns every purely-syntactic helper the later layers
share.  It knows nothing about tables, numpy, or devices — the numpy
interpreter lives in ``core/sql.py``, the logical planner in
``core/sql_plan.py``, and the compiled torch executor in
``core/sql_compile.py``.

The supported grammar is documented where users meet it: the module
docstring of ``core/sql.py``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any


def parse(query: str):
    """Query string -> AST (:class:`_Query` | :class:`_Union`)."""
    return _Parser(query).parse()


_TOKEN = re.compile(
    r"\s*(?:"
    r"(?P<str>'(?:[^']|'')*')"
    r"|(?P<num>-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)"
    r"|(?P<word>[A-Za-z_][A-Za-z_0-9]*)"
    r"|(?P<op><=|>=|!=|<>|=|<|>|\(|\)|\*|,|\.|\+|-|/)"
    r")"
)

_AGGS = {"count", "sum", "avg", "min", "max"}
#: scalar functions usable in expressions (names stay valid column
#: identifiers when not followed by "(")
_SCALAR_FUNCS = {
    "abs", "round", "upper", "lower", "length", "coalesce",
    # date/time scalars for the timestamped-events schema (reference
    # window extraction, mllearnforhospitalnetwork.py:123-128)
    "date_trunc", "unix_timestamp", "datediff",
}
_KEYWORDS = {
    "select", "from", "where", "group", "by", "order", "limit",
    "and", "or", "between", "as", "asc", "desc",
    "distinct", "join", "inner", "left", "on", "having",
    # right/full/outer stay NON-reserved (Spark parity: legal as column
    # names) — the join grammar consumes them contextually
    "case", "when", "then", "else", "end",
    "not", "is", "null", "in",
    "union", "all", "intersect", "except",
    "over", "partition",
} | _AGGS

#: ranking window functions (parse as name() calls, require OVER)
_RANK_FUNCS = {"row_number", "rank", "dense_rank"}
#: offset window functions: lag(col[, offset]) / lead(col[, offset])
_SHIFT_FUNCS = {"lag", "lead"}
#: frame-edge window functions (one column arg)
_EDGE_FUNCS = {"first_value", "last_value"}
#: every AST node kind that is a window function (must carry OVER)
_WINDOW_NODES = frozenset({"rankfn", "shiftfn", "ntilefn", "edgefn"})


def _tokenize(query: str) -> list[tuple[str, str]]:
    out, pos = [], 0
    query = query.strip()  # the token regex needs a token after \s*
    while pos < len(query):
        m = _TOKEN.match(query, pos)
        if not m:
            raise ValueError(f"SQL syntax error at: {query[pos:pos + 20]!r}")
        pos = m.end()
        if m.lastgroup == "str":
            out.append(("str", m.group("str")[1:-1].replace("''", "'")))
        elif m.lastgroup == "num":
            out.append(("num", m.group("num")))
        elif m.lastgroup == "word":
            w = m.group("word")
            out.append(("kw", w.lower()) if w.lower() in _KEYWORDS else ("name", w))
        else:
            out.append(("op", m.group("op")))
    return out
@dataclass
class _SelectItem:
    agg: str | None      # None = plain column / expression
    col: str | None      # None = COUNT(*) / expression; "*" = star-plus
    alias: str
    # arithmetic expression AST (("col",name) | ("lit",v) | ("agg",name) |
    # ("neg",e) | ("bin",op,l,r)); None for the simple col/agg fast paths
    expr: tuple | None = None
    # window spec (partition_cols tuple, (order_col, desc) | None) for
    # `agg(col) OVER (...)` / ranking functions; None = not windowed
    window: tuple | None = None
def _expr_has_window_fn(e) -> bool:
    """True when a rankfn/shiftfn node appears ANYWHERE in the tree —
    nested window functions inside arithmetic have no evaluation rule
    and must be rejected at parse time, not crash the evaluator."""
    if e is None:
        return False
    k = e[0]
    if k in _WINDOW_NODES:
        return True
    if k == "neg":
        return _expr_has_window_fn(e[1])
    if k == "bin":
        return _expr_has_window_fn(e[2]) or _expr_has_window_fn(e[3])
    if k == "case":
        return any(_expr_has_window_fn(v) for _, v in e[1]) or (
            _expr_has_window_fn(e[2])
        )
    if k == "fn":
        return any(_expr_has_window_fn(a) for a in e[2])
    if k == "aggex":
        return _expr_has_window_fn(e[2])
    if k == "pct":
        return _expr_has_window_fn(e[1])
    return False


def _expr_has_agg(e) -> bool:
    if e is None:
        return False
    k = e[0]
    if k == "agg":
        return True
    if k == "neg":
        return _expr_has_agg(e[1])
    if k == "bin":
        return _expr_has_agg(e[2]) or _expr_has_agg(e[3])
    if k == "case":
        return any(_expr_has_agg(v) for _, v in e[1]) or _expr_has_agg(e[2])
    if k == "fn":
        return any(_expr_has_agg(a) for a in e[2])
    if k in ("aggex", "pct"):
        return True
    return False
def _cond_cols(c) -> list[str]:
    """Column names referenced by a predicate tree."""
    if c is None:
        return []
    k = c[0]
    if k in ("and", "or"):
        return _cond_cols(c[1]) + _cond_cols(c[2])
    if k == "not":
        return _cond_cols(c[1])
    return [c[1]]  # between / cmp / in / isnull carry the name at index 1


def _expr_cols(e) -> list[str]:
    """Bare (non-aggregate) column atoms of an expression."""
    if e is None:
        return []
    k = e[0]
    if k == "col":
        return [e[1]]
    if k == "neg":
        return _expr_cols(e[1])
    if k == "bin":
        return _expr_cols(e[2]) + _expr_cols(e[3])
    if k == "case":
        out: list[str] = []
        for cond, v in e[1]:
            out += _cond_cols(cond) + _expr_cols(v)
        return out + _expr_cols(e[2])
    if k == "fn":
        out = []
        for a in e[2]:
            out += _expr_cols(a)
        return out
    return []


def _render_expr(e) -> str:
    """Default output name for an un-aliased expression (Spark-style)."""
    k = e[0]
    if k == "col":
        return e[1].split(".")[-1]
    if k == "lit":
        return str(e[1])
    if k == "agg":
        return e[1]
    if k == "neg":
        return f"-{_render_expr(e[1])}"
    if k == "case":
        return "CASE"
    if k == "fn":
        return f"{e[1]}({', '.join(_render_expr(a) for a in e[2])})"
    if k == "rankfn":
        return f"{e[1]}()"
    if k == "shiftfn":
        return f"{e[1]}({e[2]})" if e[3] == 1 else f"{e[1]}({e[2]}, {e[3]})"
    if k == "ntilefn":
        return f"ntile({e[1]})"
    if k == "edgefn":
        return f"{e[1]}({e[2]})"
    if k == "aggex":
        return f"{e[1]}({_render_expr(e[2])})"
    if k == "pct":
        return f"percentile({_render_expr(e[1])}, {e[2]:g})"
    return f"({_render_expr(e[2])} {e[1]} {_render_expr(e[3])})"
@dataclass
class _Query:
    items: list | None   # None = SELECT *
    distinct: bool
    table: tuple         # (name, alias)
    joins: list          # [(kind, (name, alias), left_key, right_key), ...]
    where: Any
    group: list
    having: Any
    order: tuple | None
    limit: int | None


@dataclass
class _Union:
    """Set-operation chain: left-associative folds over UNION [ALL] /
    INTERSECT / EXCEPT steps (INTERSECT parsed at higher precedence,
    standard SQL), then one trailing ORDER BY/LIMIT over the combined
    result."""

    queries: list          # [_Query | _Union, ...] (order/limit stripped)
    ops: list              # per step: "union" | "union_all" | "intersect"
    #                        | "except"  (len = len(queries)-1)
    order: tuple | None
    limit: int | None


def _take_order_limit(node) -> tuple:
    """Detach (order, limit) from a chain branch (query or nested
    chain) so they can bind the enclosing chain instead."""
    order, limit = node.order, node.limit
    node.order = node.limit = None
    return order, limit


def _require_no_order_limit(node) -> None:
    if node.order is not None or node.limit is not None:
        raise ValueError(
            "SQL: ORDER BY/LIMIT inside a set-operation branch is not "
            "supported — a trailing ORDER BY/LIMIT applies to the whole "
            "chain"
        )

class _Parser:
    def __init__(self, query: str):
        self.toks = _tokenize(query)
        self.i = 0

    def _peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else ("eof", "")

    def _peek_at(self, k: int):
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else ("eof", "")

    def _starts_join_clause(self) -> bool:
        """True when the CURRENT name token begins ``RIGHT|FULL [OUTER]
        JOIN`` / ``CROSS JOIN`` — so ``FROM t RIGHT JOIN u`` doesn't eat
        RIGHT as t's alias (LEFT/INNER are reserved keywords and need no
        lookahead)."""
        t = self._peek()
        if t[0] != "name" or t[1].lower() not in ("right", "full", "cross"):
            return False
        nxt = self._peek_at(1)
        return nxt == ("kw", "join") or (
            nxt[0] == "name" and nxt[1].lower() == "outer"
        )

    def _accept_word(self, word: str) -> bool:
        """Consume a NON-reserved word used contextually (RIGHT/FULL/
        OUTER in join clauses) — it tokenizes as a name, staying legal
        as a column identifier everywhere else."""
        t = self._peek()
        if t[0] == "name" and t[1].lower() == word:
            self.i += 1
            return True
        return False

    def _next(self):
        t = self._peek()
        self.i += 1
        return t

    def _expect(self, kind, value=None):
        t = self._next()
        if t[0] != kind or (value is not None and t[1] != value):
            raise ValueError(f"SQL: expected {value or kind}, got {t[1]!r}")
        return t

    def _accept(self, kind, value=None):
        t = self._peek()
        if t[0] == kind and (value is None or t[1] == value):
            self.i += 1
            return True
        return False

    # ---- grammar ----
    def parse(self):
        """Top level: one select, or a UNION [ALL] chain.  Spark binds a
        trailing ORDER BY/LIMIT to the WHOLE union, which falls out of
        greedy per-select parsing: the last branch's order/limit become
        the union's; earlier branches must not carry any."""
        node = self._union_chain()
        if self._peek()[0] != "eof":
            raise ValueError(
                f"SQL: unexpected trailing input {self._peek()[1]!r}"
            )
        return node

    def _union_chain(self):
        """Set-op grammar with standard precedence — INTERSECT binds
        tighter than UNION/EXCEPT:

            chain     := intersects ((UNION [ALL|DISTINCT] | EXCEPT
                         [DISTINCT]) intersects)*
            intersects := select (INTERSECT [DISTINCT] select)*

        → _Query | _Union.  The trailing ORDER BY/LIMIT of the chain's
        LAST select binds the whole chain (Spark); any earlier select
        carrying one raises."""
        first = self._intersect_chain()
        steps: list[tuple[str, Any]] = []
        while True:
            if self._accept("kw", "union"):
                all_ = bool(self._accept("kw", "all"))
                if not all_:
                    self._accept("kw", "distinct")  # UNION DISTINCT = UNION
                steps.append(
                    ("union_all" if all_ else "union", self._intersect_chain())
                )
            elif self._accept("kw", "except"):
                if self._peek() == ("kw", "all"):
                    raise ValueError(
                        "SQL: EXCEPT ALL (bag semantics) is not supported — "
                        "EXCEPT returns distinct rows"
                    )
                self._accept("kw", "distinct")
                steps.append(("except", self._intersect_chain()))
            else:
                break
        if not steps:
            return first
        queries = [first] + [q for _, q in steps]
        order, limit = _take_order_limit(queries[-1])
        for q in queries[:-1]:
            _require_no_order_limit(q)
        return _Union(queries, [op for op, _ in steps], order, limit)

    def _intersect_chain(self):
        first = self._select_query()
        steps = []
        while self._accept("kw", "intersect"):
            if self._peek() == ("kw", "all"):
                raise ValueError(
                    "SQL: INTERSECT ALL (bag semantics) is not supported — "
                    "INTERSECT returns distinct rows"
                )
            self._accept("kw", "distinct")
            steps.append(("intersect", self._select_query()))
        if not steps:
            return first
        queries = [first] + [q for _, q in steps]
        # the last select's order/limit becomes THIS chain's; the outer
        # chain takes it over (or rejects it) if this chain isn't final
        order, limit = _take_order_limit(queries[-1])
        for q in queries[:-1]:
            _require_no_order_limit(q)
        return _Union(queries, [op for op, _ in steps], order, limit)

    def _select_query(self):
        self._expect("kw", "select")
        distinct = self._accept("kw", "distinct")
        items = self._select_list()
        self._expect("kw", "from")
        table = self._table_ref()
        joins = []
        while True:
            if self._accept("kw", "join"):
                kind = "inner"
            elif self._accept("kw", "inner"):
                self._expect("kw", "join")
                kind = "inner"
            elif self._accept("kw", "left"):
                self._accept_word("outer")  # LEFT OUTER JOIN synonym
                self._expect("kw", "join")
                kind = "left"
            elif self._accept_word("right"):
                self._accept_word("outer")
                self._expect("kw", "join")
                kind = "right"
            elif self._accept_word("full"):
                self._accept_word("outer")
                self._expect("kw", "join")
                kind = "full"
            elif self._accept_word("cross"):
                self._expect("kw", "join")
                joins.append(("cross", self._table_ref(), None, None))
                continue
            else:
                break
            right = self._table_ref()
            self._expect("kw", "on")
            lk = self._name()
            self._expect("op", "=")
            rk = self._name()
            joins.append((kind, right, lk, rk))
        where = None
        if self._accept("kw", "where"):
            where = self._or_cond()
        group = []
        if self._accept("kw", "group"):
            self._expect("kw", "by")
            group = [self._group_item()]
            while self._accept("op", ","):
                group.append(self._group_item())
        having = None
        if self._accept("kw", "having"):
            having = self._or_cond(allow_agg=True)
        order = None
        if self._accept("kw", "order"):
            self._expect("kw", "by")
            col = self._name(allow_agg=True)
            desc = False
            if self._accept("kw", "desc"):
                desc = True
            else:
                self._accept("kw", "asc")
            order = (col, desc)
        limit = None
        if self._accept("kw", "limit"):
            limit = int(self._expect("num")[1])
        return _Query(
            items, distinct, table, joins, where, group, having, order, limit
        )

    def _table_ref(self):
        """name [[AS] alias] → (table_name, alias); or a derived table
        ``( <select [UNION …]> ) alias`` → (query AST, alias) — the
        executor runs the sub-select and treats its result as the
        table (Spark's FROM-subquery)."""
        if self._accept("op", "("):
            node = self._union_chain()
            self._expect("op", ")")
            alias = None
            if self._accept("kw", "as"):
                alias = self._expect("name")[1]
            elif self._peek()[0] == "name" and not self._starts_join_clause():
                alias = self._next()[1]
            if alias is None:
                raise ValueError("SQL: a FROM subquery needs an alias")
            return node, alias
        name = self._expect("name")[1]
        alias = name
        if self._accept("kw", "as"):
            alias = self._expect("name")[1]
        elif self._peek()[0] == "name" and not self._starts_join_clause():
            alias = self._next()[1]
        return name, alias

    def _name(self, allow_agg: bool = False) -> str:
        """Possibly-qualified column reference → "alias.col" | "col";
        with ``allow_agg``, also "agg(col)" / "count(*)" (HAVING/ORDER).
        Delegates aggregate parsing to :meth:`_agg_factor` — ONE copy of
        the COUNT(*) rule and canonical spelling, so SELECT and
        HAVING/ORDER BY references can never drift."""
        if allow_agg and self._peek()[0] == "kw" and self._peek()[1] in _AGGS:
            node = self._agg_factor()
            if node[0] != "agg":
                raise ValueError(
                    "SQL: aggregates over expressions (e.g. SUM(CASE … END)) "
                    "are only supported in the select list — alias the "
                    "select item and reference the alias here"
                )
            return node[1]
        t = self._next()
        if t[0] != "name":
            raise ValueError(f"SQL: expected a column name, got {t[1]!r}")
        if t[1].lower() in _SCALAR_FUNCS and self._peek() == ("op", "("):
            raise ValueError(
                f"SQL: scalar function {t[1].upper()} is only supported in "
                "the select list — compute it there (… AS alias) and "
                "reference the alias here"
            )
        if t[1].lower() in ("median", "percentile_approx") and (
            self._peek() == ("op", "(")
        ):
            raise ValueError(
                f"SQL: {t[1].upper()} is only supported in the select "
                "list — alias the select item and reference the alias here"
            )
        return self._qual_tail(t[1])

    def _qual_tail(self, first: str) -> str:
        if self._accept("op", "."):
            return f"{first}.{self._expect('name')[1]}"
        return first

    def _select_list(self):
        if self._accept("op", "*"):
            if not self._accept("op", ","):
                return None  # SELECT *
            # SELECT *, expr AS x, ... — Spark's SQLTransformer shape:
            # the star expands at projection time, the extras append
            items = [_SelectItem(None, "*", "*")]
            items.append(self._select_item())
            while self._accept("op", ","):
                items.append(self._select_item())
            return items
        items = [self._select_item()]
        while self._accept("op", ","):
            items.append(self._select_item())
        return items

    def _group_item(self):
        """GROUP BY item: a plain column name (string, the common case)
        or an expression AST (``GROUP BY CASE … END`` bucketing)."""
        e = self._expr()
        if e[0] == "col":
            return e[1]
        if _expr_has_agg(e):
            raise ValueError("SQL: aggregates are not allowed in GROUP BY")
        return e

    def _select_item(self) -> _SelectItem:
        e = self._expr()
        window = None
        if self._accept("kw", "over"):
            if e[0] != "agg" and e[0] not in _WINDOW_NODES:
                raise ValueError(
                    "SQL: OVER applies to an aggregate or window function"
                )
            window = self._window_spec()
        elif e[0] in _WINDOW_NODES:
            fn = "NTILE" if e[0] == "ntilefn" else str(e[1]).upper()
            raise ValueError(f"SQL: {fn}() needs an OVER (...) window")
        elif _expr_has_window_fn(e):
            raise ValueError(
                "SQL: window functions cannot nest inside expressions — "
                "alias the window in a FROM subquery and compute on the "
                "alias"
            )
        # bare column / bare aggregate keep the legacy fast-path fields
        if e[0] == "col":
            col = e[1]
            item = _SelectItem(None, col, col.split(".")[-1])
        elif e[0] == "agg" and window is None:
            name = e[1]
            agg = name.split("(", 1)[0]
            inner = name[len(agg) + 1 : -1]
            item = _SelectItem(agg, None if inner == "*" else inner, name)
        elif window is not None:
            item = _SelectItem(
                None, None, _render_expr(e), expr=e, window=window
            )
        else:
            item = _SelectItem(None, None, _render_expr(e), expr=e)
        if self._accept("kw", "as"):
            item.alias = self._expect("name")[1]
        return item

    def _window_spec(self):
        """``( [PARTITION BY cols] [ORDER BY col [ASC|DESC]] )``."""
        self._expect("op", "(")
        partition: list[str] = []
        if self._accept("kw", "partition"):
            self._expect("kw", "by")
            partition = [self._name()]
            while self._accept("op", ","):
                partition.append(self._name())
        order = None
        if self._accept("kw", "order"):
            self._expect("kw", "by")
            col = self._name()
            desc = False
            if self._accept("kw", "desc"):
                desc = True
            else:
                self._accept("kw", "asc")
            order = (col, desc)
        self._expect("op", ")")
        return (tuple(partition), order)

    # ---- arithmetic expressions (SELECT items) ----
    def _expr(self):
        left = self._term()
        while True:
            if self._accept("op", "+"):
                left = ("bin", "+", left, self._term())
            elif self._accept("op", "-"):
                left = ("bin", "-", left, self._term())
            elif self._peek()[0] == "num" and self._peek()[1].startswith("-"):
                # "a-1" tokenizes as [a][-1]: fold the sign into a binop
                v = self._next()[1][1:]
                lit = float(v) if ("." in v or "e" in v.lower()) else int(v)
                left = ("bin", "-", left, ("lit", lit))
            else:
                return left

    def _term(self):
        left = self._factor()
        while True:
            if self._accept("op", "*"):
                left = ("bin", "*", left, self._factor())
            elif self._accept("op", "/"):
                left = ("bin", "/", left, self._factor())
            else:
                return left

    def _factor(self):
        t = self._peek()
        if t == ("op", "-"):
            self._next()
            return ("neg", self._factor())
        if t == ("op", "("):
            self._next()
            e = self._expr()
            self._expect("op", ")")
            return e
        if t[0] in ("num", "str"):
            return ("lit", self._literal())
        if t == ("kw", "case"):
            return self._case_expr()
        if t[0] == "kw" and t[1] in _AGGS:
            return self._agg_factor()
        if t[0] == "name":
            name = self._next()[1]
            if name.lower() in _RANK_FUNCS and self._accept("op", "("):
                self._expect("op", ")")
                return ("rankfn", name.lower())
            if name.lower() == "ntile" and self._accept("op", "("):
                tok = self._expect("num")[1]
                if "." in tok or "e" in tok.lower() or int(tok) < 1:
                    raise ValueError(
                        f"SQL: NTILE needs a positive integer, got {tok!r}"
                    )
                self._expect("op", ")")
                return ("ntilefn", int(tok))
            if name.lower() in _EDGE_FUNCS and self._accept("op", "("):
                col = self._name()
                self._expect("op", ")")
                return ("edgefn", name.lower(), col)
            if name.lower() in _SHIFT_FUNCS and self._accept("op", "("):
                col = self._name()
                offset = 1
                if self._accept("op", ","):
                    tok = self._expect("num")[1]
                    if "." in tok or "e" in tok.lower():
                        raise ValueError(
                            f"SQL: {name.upper()} offset must be an "
                            f"integer, got {tok!r}"
                        )
                    offset = int(tok)
                self._expect("op", ")")
                return ("shiftfn", name.lower(), col, offset)
            if name.lower() in ("percentile_approx", "median") and (
                self._accept("op", "(")
            ):
                inner = self._expr()
                if name.lower() == "median":
                    p = 0.5
                else:
                    self._expect("op", ",")
                    p = float(self._expect("num")[1])
                    if not 0.0 <= p <= 1.0:
                        raise ValueError(
                            f"SQL: percentile must be in [0, 1], got {p}"
                        )
                    if self._accept("op", ","):
                        self._expect("num")  # Spark's accuracy arg: ignored
                        # (this engine computes the EXACT percentile)
                self._expect("op", ")")
                return ("pct", inner, p)
            if name.lower() in _SCALAR_FUNCS and self._accept("op", "("):
                args = [self._expr()]
                while self._accept("op", ","):
                    args.append(self._expr())
                self._expect("op", ")")
                return ("fn", name.lower(), args)
            return ("col", self._qual_tail(name))
        raise ValueError(f"SQL: expected column, literal or aggregate, got {t[1]!r}")

    def _agg_factor(self):
        """``agg(col)`` / ``count(*)`` keep the legacy name spelling
        (HAVING/ORDER BY canonical references match on it); an aggregate
        over any OTHER expression — ``sum(CASE WHEN … END)``,
        ``avg(a*b)`` — becomes an ``aggex`` node, lowered per query."""
        agg = self._next()[1]
        self._expect("op", "(")
        if self._accept("op", "*"):
            if agg != "count":
                raise ValueError(f"SQL: {agg.upper()}(*) is not defined")
            self._expect("op", ")")
            return ("agg", "count(*)")
        inner = self._expr()
        self._expect("op", ")")
        if inner[0] == "col":
            return ("agg", f"{agg}({inner[1]})")
        return ("aggex", agg, inner)

    def _case_expr(self):
        """``CASE WHEN <cond> THEN <expr> [...] [ELSE <expr>] END`` —
        Spark's searched-CASE form (the SQL spelling of the reference's
        ``when(...).otherwise(...)`` LOS binarization,
        ``mllearnforhospitalnetwork.py:176-177``)."""
        self._expect("kw", "case")
        branches = []
        while self._accept("kw", "when"):
            cond = self._or_cond()
            self._expect("kw", "then")
            branches.append((cond, self._expr()))
        if not branches:
            raise ValueError("SQL: CASE needs at least one WHEN branch")
        default = self._expr() if self._accept("kw", "else") else None
        self._expect("kw", "end")
        return ("case", branches, default)

    def _or_cond(self, allow_agg: bool = False):
        left = self._and_cond(allow_agg)
        while self._accept("kw", "or"):
            left = ("or", left, self._and_cond(allow_agg))
        return left

    def _and_cond(self, allow_agg: bool = False):
        left = self._pred(allow_agg)
        while self._accept("kw", "and"):
            left = ("and", left, self._pred(allow_agg))
        return left

    def _pred(self, allow_agg: bool = False):
        if self._accept("kw", "not"):
            return ("not", self._pred(allow_agg))
        if self._accept("op", "("):
            c = self._or_cond(allow_agg)
            self._expect("op", ")")
            return c
        col = self._name(allow_agg=allow_agg)
        if self._accept("kw", "between"):
            lo = self._literal()
            self._expect("kw", "and")
            hi = self._literal()
            return ("between", col, lo, hi)
        if self._accept("kw", "is"):
            negate = bool(self._accept("kw", "not"))
            self._expect("kw", "null")
            node = ("isnull", col)
            return ("not", node) if negate else node
        negate = bool(self._accept("kw", "not"))
        if self._accept("kw", "in"):
            self._expect("op", "(")
            if self._peek() == ("kw", "select"):
                sub = self._union_chain()
                self._expect("op", ")")
                return ("notinsub" if negate else "insub", col, sub)
            vals = [self._literal()]
            while self._accept("op", ","):
                vals.append(self._literal())
            self._expect("op", ")")
            node = ("in", col, vals)
            # NOT IN keeps Spark null semantics: a null row fails both
            # IN and NOT IN, so the negation applies only to valid rows
            return ("notin", col, vals) if negate else node
        if negate:
            raise ValueError("SQL: expected IN after NOT")
        op = self._expect("op")[1]
        if op not in ("=", "!=", "<>", "<", "<=", ">", ">="):
            raise ValueError(f"SQL: unsupported operator {op!r}")
        return ("cmp", col, "!=" if op == "<>" else op, self._literal())

    def _literal(self):
        t = self._next()
        if t[0] == "str":
            return t[1]
        if t[0] == "num":
            return float(t[1]) if ("." in t[1] or "e" in t[1].lower()) else int(t[1])
        raise ValueError(f"SQL: expected a literal, got {t[1]!r}")
_AGG_REF = re.compile(r"^(count|sum|avg|min|max)\((.+|\*)\)$")

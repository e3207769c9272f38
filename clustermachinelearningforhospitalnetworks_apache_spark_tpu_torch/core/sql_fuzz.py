"""Fuzz parity harness: compiled executor ≡ numpy interpreter (the JAX
package's ``core/sql_fuzz.py``, drawing the same ``default_rng`` values,
so a seed gives the same tables and the same SQL in both packages).

Random queries over random tables inside the compiled subset's grammar
run on both executors (``execute(mode="interpret")`` against
``execute(mode="compile")`` on ``device=``, default the card) and must
agree — column names/order, row counts, dtype kinds, null masks exactly;
float values to 1e-9 relative (both paths compute in float64, so the
slack only absorbs reduction-order differences).

A mismatching query is **shrunk** before being reported: select items,
predicate branches, and group keys are removed one at a time while the
mismatch persists, so the failure message carries a minimal repro query.

Queries are built from a small spec tree (dicts/tuples) and rendered to
SQL, which is what makes shrinking structural rather than textual.  The
incremental leg (:func:`run_fuzz_incremental`) replays random batch and
late-row sequences through a materialized view and holds it to a full
recompute after every commit.  The generators and :func:`compare_tables`
are host work; the checkers take ``device=``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial

import numpy as np

from ..device import resolve_device
from .table import Table

_NUM_COLS = ("f1", "f2", "i1", "i2")
_FLOAT_COLS = ("f1", "f2")
_TS_COL = "t1"
_EPOCH = np.datetime64("2025-03-31T22:00:00")


def random_table(rng: np.random.Generator, n_rows: int | None = None) -> Table:
    """Numeric + timestamp + string columns with nulls where the dtype
    can hold them (NaN floats, NaT timestamps)."""
    n = int(rng.integers(0, 400)) if n_rows is None else n_rows
    f1 = rng.normal(size=n) * 10
    f1[rng.random(n) < 0.15] = np.nan
    f2 = rng.gamma(2.0, 2.0, size=n)
    f2[rng.random(n) < 0.05] = np.nan
    t1 = (
        _EPOCH + rng.integers(0, 7200, size=n).astype("timedelta64[s]")
    ).astype("datetime64[ns]")
    t1[rng.random(n) < 0.1] = np.datetime64("NaT")
    s1 = np.array(
        [f"H{int(v)}" for v in rng.integers(0, 3, size=n)], object
    )
    s1[rng.random(n) < 0.1] = None  # the null LEFT JOIN writes
    return Table.from_dict(
        {
            "f1": f1,
            "f2": f2,
            "i1": rng.integers(-3, 4, size=n),
            "i2": rng.integers(0, 100, size=n),
            "t1": t1,
            "s1": s1,
        }
    )


# ------------------------------------------------------------ spec model
@dataclass(frozen=True)
class QuerySpec:
    kind: str                 # "rowlevel" | "aggregate" | "window"
    items: tuple              # rendered select-item SQL fragments
    where: tuple | None       # cond spec tree
    group: tuple = ()         # group-key column names (aggregate)
    limit: int | None = None

    def sql(self) -> str:
        parts = ["SELECT ", ", ".join(self.items), " FROM fuzz"]
        if self.where is not None:
            parts += [" WHERE ", _render_cond(self.where)]
        if self.group:
            parts += [" GROUP BY ", ", ".join(self.group)]
        if self.limit is not None:
            parts += [f" LIMIT {self.limit}"]
        return "".join(parts)


def _lit(rng, col: str) -> str:
    if col == _TS_COL:
        off = int(rng.integers(0, 7200))
        ts = (_EPOCH + np.timedelta64(off, "s")).astype("datetime64[s]")
        return "'" + str(ts).replace("T", " ") + "'"
    if col.startswith("i"):
        return str(int(rng.integers(-5, 105)))
    v = float(np.round(rng.normal() * 8, 3))
    return repr(v)


def _random_cond(rng, depth: int = 2) -> tuple:
    roll = rng.random()
    if depth > 0 and roll < 0.35:
        op = "AND" if rng.random() < 0.5 else "OR"
        a = _random_cond(rng, depth - 1)
        b = _random_cond(rng, depth - 1)
        node = ("bool", op, a, b)
        return ("not", node) if rng.random() < 0.15 else node
    col = str(rng.choice(_NUM_COLS + (_TS_COL,)))
    kind = rng.random()
    if kind < 0.15:
        neg = "NOT " if rng.random() < 0.5 else ""
        return ("leaf", f"{col} IS {neg}NULL")
    if kind < 0.3:
        lo, hi = sorted([_lit(rng, col), _lit(rng, col)])
        return ("leaf", f"{col} BETWEEN {lo} AND {hi}")
    if kind < 0.45 and col != _TS_COL:
        vals = ", ".join(_lit(rng, col) for _ in range(int(rng.integers(1, 4))))
        neg = "NOT " if rng.random() < 0.3 else ""
        return ("leaf", f"{col} {neg}IN ({vals})")
    op = str(rng.choice(["=", "!=", "<", "<=", ">", ">="]))
    return ("leaf", f"{col} {op} {_lit(rng, col)}")


def _render_cond(c) -> str:
    if c[0] == "leaf":
        return c[1]
    if c[0] == "not":
        return f"NOT ({_render_cond(c[1])})"
    _, op, a, b = c
    return f"({_render_cond(a)} {op} {_render_cond(b)})"


def _random_expr(rng, depth: int = 2) -> str:
    roll = rng.random()
    if depth == 0 or roll < 0.35:
        return str(rng.choice(_NUM_COLS))
    if roll < 0.45:
        return _lit(rng, str(rng.choice(("i1", "f1"))))
    if roll < 0.55:
        return f"abs({_random_expr(rng, depth - 1)})"
    if roll < 0.62:
        return f"coalesce({rng.choice(_FLOAT_COLS)}, {_random_expr(rng, depth - 1)})"
    if roll < 0.72:
        cond = _render_cond(_random_cond(rng, 1))
        a = _random_expr(rng, depth - 1)
        b = _random_expr(rng, depth - 1)
        tail = f" ELSE {b} END" if rng.random() < 0.8 else " END"
        return f"CASE WHEN {cond} THEN {a}{tail}"
    op = str(rng.choice(["+", "-", "*", "/"]))
    return f"({_random_expr(rng, depth - 1)} {op} {_random_expr(rng, depth - 1)})"


def random_query(rng: np.random.Generator) -> QuerySpec:
    shape = rng.random()
    where = _random_cond(rng) if rng.random() < 0.7 else None
    if shape < 0.45:  # row-level projection
        n_items = int(rng.integers(1, 4))
        items = []
        for j in range(n_items):
            if rng.random() < 0.4:
                items.append(str(rng.choice(_NUM_COLS + (_TS_COL, "s1"))))
            else:
                items.append(f"{_random_expr(rng)} AS e{j}")
        items = list(dict.fromkeys(items))  # duplicate bare columns drop
        limit = int(rng.integers(1, 50)) if rng.random() < 0.2 else None
        return QuerySpec("rowlevel", tuple(items), where, limit=limit)
    if shape < 0.8:  # aggregate
        n_keys = int(rng.integers(0, 3))
        keys = tuple(
            dict.fromkeys(
                str(rng.choice(_NUM_COLS + (_TS_COL, "s1")))
                for _ in range(n_keys)
            )
        )
        items = list(keys)
        for j in range(int(rng.integers(1, 4))):
            agg = str(rng.choice(["count", "sum", "avg", "min", "max"]))
            src = "*" if agg == "count" and rng.random() < 0.3 else str(
                rng.choice(_NUM_COLS)
            )
            items.append(f"{agg}({src}) AS a{j}")
        return QuerySpec("aggregate", tuple(items), where, group=keys)
    # whole-partition window
    agg = str(rng.choice(["count", "sum", "avg", "min", "max"]))
    src = str(rng.choice(_NUM_COLS))
    parts = ", ".join(
        dict.fromkeys(
            str(rng.choice(_NUM_COLS)) for _ in range(int(rng.integers(1, 3)))
        )
    )
    items = (src, f"{agg}({src}) OVER (PARTITION BY {parts}) AS w0")
    return QuerySpec("window", items, where)


# ------------------------------------------------------------ the check
def compare_tables(ti: Table, tc: Table) -> str | None:
    """None when equal under the pinned semantics; else a description."""
    if list(ti.columns) != list(tc.columns):
        return f"columns {list(ti.columns)} != {list(tc.columns)}"
    if len(ti) != len(tc):
        return f"row count {len(ti)} != {len(tc)}"
    for c in ti.columns:
        vi, vc = ti.column(c), tc.column(c)
        if vi.dtype.kind != vc.dtype.kind:
            return f"column {c!r} dtype {vi.dtype} != {vc.dtype}"
        if vi.dtype.kind == "f":
            if not np.array_equal(np.isnan(vi), np.isnan(vc)):
                return f"column {c!r} null masks differ"
            if not np.allclose(vi, vc, rtol=1e-9, atol=1e-12, equal_nan=True):
                return f"column {c!r} values differ: {vi[:5]} vs {vc[:5]}"
        elif vi.dtype.kind == "M":
            # NaT != NaT: compare null masks and the non-null values
            ni, nc = np.isnat(vi), np.isnat(vc)
            if not np.array_equal(ni, nc):
                return f"column {c!r} null masks differ"
            if not np.array_equal(vi[~ni], vc[~nc]):
                return f"column {c!r} values differ: {vi[:5]} vs {vc[:5]}"
        else:
            if not np.array_equal(vi, vc):
                return f"column {c!r} values differ: {vi[:5]} vs {vc[:5]}"
    return None


def check_spec(spec: QuerySpec, table: Table, device=None) -> str | None:
    """Run one spec on both executors, the compiled one on ``device``
    (default the card).  → None (parity), a mismatch description, or
    None-with-skip when the plan legitimately falls back (the generator
    aims inside the subset, but e.g. a string projection item next to
    GROUP BY may step out)."""
    from .sql import SqlCompileUnsupported, execute

    device = resolve_device(device)    # no card: raise here, not as a mismatch
    q = spec.sql()

    def resolve(_name: str) -> Table:
        return table

    try:
        tc = execute(q, resolve, mode="compile", device=device)
    except SqlCompileUnsupported:
        return None  # legitimate fallback — not a parity case
    except Exception as e:  # compiled crash where interpreter works IS a bug
        try:
            execute(q, resolve, mode="interpret")
        except Exception:
            return None  # both raise: error parity (messages may differ)
        return f"compiled path raised {type(e).__name__}: {e}"
    try:
        ti = execute(q, resolve, mode="interpret")
    except Exception as e:
        return f"interpreter raised {type(e).__name__}: {e} (compiled ran)"
    return compare_tables(ti, tc)


def _shrink_candidates(spec: QuerySpec):
    """Structurally smaller specs, most aggressive first."""
    if spec.where is not None:
        yield replace(spec, where=None)
        c = spec.where
        if c[0] == "bool":
            yield replace(spec, where=c[2])
            yield replace(spec, where=c[3])
        elif c[0] == "not":
            yield replace(spec, where=c[1])
    if spec.limit is not None:
        yield replace(spec, limit=None)
    if len(spec.items) > 1:
        for k in range(len(spec.items)):
            kept = spec.items[:k] + spec.items[k + 1 :]
            if spec.kind == "aggregate":
                # keep the items/keys relationship coherent: dropping a
                # key item drops the key too
                dropped = spec.items[k]
                group = tuple(g for g in spec.group if g != dropped)
                if not any(it not in group for it in kept):
                    continue  # would leave keys only — not a valid list
                yield replace(spec, items=kept, group=group)
            else:
                yield replace(spec, items=kept)


def shrink(
    spec: QuerySpec, table, max_steps: int = 200, check=None
) -> QuerySpec:
    """Greedy minimization: keep applying the first still-failing
    reduction until none applies.  ``check(spec, ctx)`` defaults to the
    two-executor parity check on the card (resolved at call time, so
    tests can monkeypatch it); the harnesses pass their checker bound to
    their device, the incremental leg :func:`check_view_spec` with its
    batch/replay sequence as ``ctx`` — one shrinker for both."""
    if check is None:
        check = check_spec
    steps = 0
    while steps < max_steps:
        for cand in _shrink_candidates(spec):
            if check(cand, table):
                spec = cand
                steps += 1
                break
        else:
            return spec
    return spec


def run_fuzz(
    n_queries: int = 40, seed: int = 0, n_rows: int | None = None, device=None
) -> list[tuple[str, str]]:
    """→ list of (minimal_query_sql, mismatch) — empty means parity is
    green across the sampled subset.  The compiled executor runs on
    ``device`` (default the card, which must then be present)."""
    device = resolve_device(device)
    check = partial(check_spec, device=device)
    rng = np.random.default_rng(seed)
    failures: list[tuple[str, str]] = []
    table = random_table(rng, n_rows)
    for i in range(n_queries):
        if i and i % 10 == 0:
            table = random_table(rng, n_rows)  # fresh data periodically
        spec = random_query(rng)
        bad = check(spec, table)
        if bad:
            small = shrink(spec, table, check=check)
            failures.append((small.sql(), check(small, table) or bad))
    return failures


# ------------------------------------------------- incremental-view leg
@dataclass(frozen=True)
class ReplaySeq:
    """One randomized ingest history: initial batches (ids 0..n−1) then
    replays — ``(batch_id, new_table)`` overwrites of an already-
    committed batch, the late-row/retraction path."""

    batches: tuple
    replays: tuple = ()


def mergeable_query(rng: np.random.Generator) -> QuerySpec:
    """A random query inside the view layer's mergeable subset: no
    whole-partition windows, no LIMIT (both are full-recompute-only —
    ``core/sql_views.py`` reason constants)."""
    while True:
        spec = random_query(rng)
        if spec.kind != "window" and spec.limit is None:
            return spec


def check_view_spec(spec: QuerySpec, seq: ReplaySeq, device=None) -> str | None:
    """Replay one randomized batch/late-row sequence through an unbounded
    table with a registered materialized view (maintained on ``device``,
    default the card) and assert, exactly after every commit, view state
    == full recompute (the numpy interpreter over the table's snapshot).
    → None (parity) or a mismatch description."""
    import shutil
    import tempfile

    from ..streaming.unbounded_table import UnboundedTable
    from .sql import execute
    from .sql_views import ViewRegistry

    device = resolve_device(device)
    q = spec.sql()
    d = tempfile.mkdtemp(prefix="sql_view_fuzz_")
    try:
        sink = UnboundedTable(d, seq.batches[0].schema, name="fuzz")
        reg = ViewRegistry(device=device)
        view = reg.register("fuzz_view", q, sink)

        def compare(step: str) -> str | None:
            got = view.read()
            snap = sink.read()
            want = execute(q, lambda _n: snap, mode="interpret")
            bad = compare_tables(want, got)
            return f"{step}: {bad}" if bad else None

        for bid, t in enumerate(seq.batches):
            sink.append_batch(t, bid)
            reg.maintain(sink, bid)
            bad = compare(f"after batch {bid}")
            if bad:
                return bad
        for bid, t in seq.replays:
            sink.append_batch(t, bid)
            reg.maintain(sink, bid)
            bad = compare(f"after replaying batch {bid}")
            if bad:
                return bad
        return None
    finally:
        shutil.rmtree(d, ignore_errors=True)


def run_fuzz_incremental(
    n_queries: int = 10, seed: int = 0, device=None
) -> list[tuple[str, str]]:
    """Incremental leg of the harness: random mergeable-subset queries
    over randomized batch/late-row sequences, view state (maintained on
    ``device``, default the card) checked against a full recompute after
    every commit; mismatches come back shrunk (the same structural
    shrinker as :func:`run_fuzz`)."""
    device = resolve_device(device)
    check = partial(check_view_spec, device=device)
    rng = np.random.default_rng(seed)
    failures: list[tuple[str, str]] = []
    for _ in range(n_queries):
        n_batches = int(rng.integers(2, 5))
        batches = tuple(
            random_table(rng, int(rng.integers(0, 120)))
            for _ in range(n_batches)
        )
        replays = ()
        if rng.random() < 0.6:
            replays = (
                (
                    int(rng.integers(0, n_batches)),
                    random_table(rng, int(rng.integers(1, 120))),
                ),
            )
        seq = ReplaySeq(batches, replays)
        spec = mergeable_query(rng)
        bad = check(spec, seq)
        if bad:
            small = shrink(spec, seq, check=check)
            failures.append((small.sql(), check(small, seq) or bad))
    return failures

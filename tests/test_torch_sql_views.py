"""Materialized views: the port's ``core/sql_views.py`` (with the partials
of ``core/sql_compile.py`` and the views' routes through ``core/sql.py``,
the stream and the Session) against the JAX package, on the CPU.

The reference is the JAX package's host route: its interpreter
(``execute(mode="interpret")``) over the same snapshot, its
``partial_plan_outputs`` and ``explain``.  No test calls the JAX compiled
route, so no JAX view runs here.  The port's views maintain on
``device="cpu"``.

Tolerances, and why:
- a view against the interpreter: the JAX fuzz harness's
  ``compare_tables`` — null masks, dtypes and row order exact, floats
  within rtol 1e-9, atol 1e-12: a view adds per-batch float64 partial
  sums, the interpreter sums all rows at once;
- everything else is exact: the rewrite's tuples, counts, min/max, keys,
  decisions, and a view resumed after a kill against an uninterrupted
  one (``tobytes``: the same batches fold in the same order).
"""

import os

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.core import sql as Jsql
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.core import (
    sql_compile as Jcompile,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.core.sql_fuzz import (
    compare_tables,
)
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core import sql as Psql
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core import sql_compile
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core.sql_parse import parse
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core.sql_plan import (
    plan_query,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core.sql_views import (
    DECISION_INCREMENTAL,
    FULL_COMPILE_DISABLED,
    FULL_LIMIT,
    FULL_NOT_COMPILED,
    FULL_WINDOW,
    ViewRegistry,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core.table_lifecycle import (
    RetentionPolicy,
    TableLifecycle,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.obs.registry import (
    global_registry,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.streaming import (
    FileStreamSource,
    StreamCheckpoint,
    StreamExecution,
    UnboundedTable,
    WatermarkTracker,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import faults

# the suite runs several worker processes on a few cores: one intra-op
# thread per worker keeps torch from oversubscribing them
torch.set_num_threads(1)

CPU = "cpu"
AGG_Q = ("SELECT i1, count(*) AS c, sum(f1) AS s, avg(f1) AS a,"
         " min(f1) AS lo, max(f1) AS hi FROM events GROUP BY i1")
ROW_Q = "SELECT f1, i1, abs(f1) AS af FROM events WHERE i1 >= 1"
TS_Q = "SELECT t1, count(f1) AS c, avg(f1) AS a FROM events GROUP BY t1"
STR_Q = "SELECT s1, count(*) AS c, sum(f1) AS s, min(f1) AS lo FROM events GROUP BY s1"
STR_WHERE_Q = "SELECT s1, count(*) AS c, avg(f1) AS a FROM events WHERE i1 >= 1 GROUP BY s1"
STATS_Q = ("SELECT count(*) AS c, sum(admission_count) AS adm,"
           " avg(length_of_stay) AS alos FROM events")


@pytest.fixture(autouse=True)
def _flight_dumps_under_tmp(tmp_path, monkeypatch):
    """Injected crashes write postmortems; keep them in the test's tree."""
    monkeypatch.setenv("CMLHN_FLIGHT_DIR", str(tmp_path / "flight"))


def _batch(rng, n, null_rate=0.15):
    f1 = rng.normal(size=n) * 10
    if n:
        f1[rng.random(n) < null_rate] = np.nan
    t1 = (np.datetime64("2025-03-31T22:00:00")
          + rng.integers(0, 7200, n).astype("timedelta64[s]")).astype("datetime64[ns]")
    return P.Table.from_dict({"f1": f1, "i1": rng.integers(-2, 4, n), "t1": t1})


def _timed_batch(rng, b, n=60, nat=False):
    if nat:
        t = np.full(n, np.datetime64("NaT"), dtype="datetime64[ns]")
    else:
        t = (np.datetime64("2025-03-31T00:00:00")
             + (b * 3600 + rng.integers(0, 3600, n)).astype("timedelta64[s]")
             ).astype("datetime64[ns]")
    return P.Table.from_dict({"f1": rng.normal(size=n), "i1": rng.integers(0, 4, n), "t1": t})


def _str_batch(rng, n, pool):
    f1 = rng.normal(size=n) * 10
    s1 = np.array([pool[int(i)] for i in rng.integers(0, len(pool), n)], dtype=object)
    if n >= 8:  # a small schema-probe batch stays null-free
        f1[rng.random(n) < 0.1] = np.nan
        s1[rng.random(n) < 0.12] = None
    return P.Table.from_dict({"f1": f1, "i1": rng.integers(-2, 4, n), "s1": s1})


def _sink(tmp_path, probe, name="table"):
    return UnboundedTable(str(tmp_path / name), probe.schema, name="events")


def _reference(query, sink, upto=None):
    """The JAX package's interpreter over the port sink's snapshot."""
    snap = sink.read(upto_batch_id=upto)
    jt = J.Table.from_dict({c: snap.column(c) for c in snap.schema.names})
    return Jsql.execute(query, lambda _n: jt, mode="interpret")


def _parity(query, sink, view, upto=None, ctx=""):
    bad = compare_tables(_reference(query, sink, upto), view.read(upto_batch_id=upto))
    assert bad is None, f"{ctx}: {bad}"


def _same(a, b):
    assert list(a.columns) == list(b.columns)
    assert len(a) == len(b)
    for c in a.columns:
        va, vb = a.column(c), b.column(c)
        assert va.dtype == vb.dtype, c
        if va.dtype == object:
            assert list(va) == list(vb), c
        else:
            assert va.tobytes() == vb.tobytes(), c


def _counter(name):
    return global_registry().counters.get(name, 0.0)


# ===================================================== the partials
PARTIAL_QUERIES = [
    AGG_Q, TS_Q, STR_Q, STR_WHERE_Q,
    "SELECT count(*) AS c, sum(f1) AS s, min(f1) AS lo FROM events",
    "SELECT i1, t1, count(f1) AS n, max(f1) AS m, avg(i1) AS ai FROM events GROUP BY i1, t1",
    "SELECT i1 FROM events GROUP BY i1",
    "SELECT i1, avg(f1) AS a, sum(f1) AS s, count(f1) AS n FROM events WHERE f1 > 0 GROUP BY i1",
]


def _probe(rng=None):
    rng = rng or np.random.default_rng(0)
    b = _batch(rng, 90)
    return P.Table.from_dict({**{c: b.column(c) for c in b.columns},
                              "s1": np.array([["H1", "H0", None][i % 3] for i in range(90)],
                                             object)})


@pytest.mark.parametrize("q", PARTIAL_QUERIES)
def test_partial_plan_outputs_equal_the_reference(q):
    table = _probe()
    plan = plan_query(parse(q), lambda _n: table)
    assert sql_compile.partial_plan_outputs(plan.outputs, plan.group_keys) == \
        Jcompile.partial_plan_outputs(plan.outputs, plan.group_keys)


@pytest.mark.parametrize("q", PARTIAL_QUERIES)
def test_run_partial_aggregate_matches_the_reference_interpreter(q):
    """Each accumulator against the JAX interpreter's own aggregate over
    the batch: rows, counts, min and max exactly, sums within rtol 1e-9
    (the partial groups by sort, the interpreter by reduceat)."""
    table = _probe()
    plan = plan_query(parse(q), lambda _n: table)
    keys, mat, accs = sql_compile.run_partial_aggregate(plan, table, device=CPU)
    items = [f"{src} AS k{i}" for i, (src, _ch) in enumerate(plan.group_keys)]
    for j, a in enumerate(accs):
        items.append("count(*)" if a[0] == "rows" else
                     f"{ {'n': 'count', 's': 'sum'}.get(a[0], a[0])}({a[1]})")
        items[-1] += f" AS a{j}"
    rq = f"SELECT {', '.join(items)} FROM events"
    if plan.filter is not None:
        rq += " WHERE " + q.split(" WHERE ")[1].split(" GROUP BY ")[0]
    if plan.group_keys:
        rq += " GROUP BY " + ", ".join(src for src, _ in plan.group_keys)
    jt = J.Table.from_dict({c: table.column(c) for c in table.schema.names})
    want = Jsql.execute(rq, lambda _n: jt, mode="interpret")
    assert mat.dtype == np.float64 and mat.shape == (len(want), len(accs))
    for i, (src, ch) in enumerate(plan.group_keys):
        w = want.column(f"k{i}")
        if ch == "t":
            assert keys[i].dtype == np.int64
            np.testing.assert_array_equal(keys[i], w.astype("datetime64[ns]").view(np.int64))
        elif ch == "s":
            assert keys[i].dtype == object and keys[i].tolist() == w.tolist()
        else:
            assert keys[i].dtype == (np.float64 if ch == "f" else np.int64)
            np.testing.assert_array_equal(keys[i], w)
    for j, a in enumerate(accs):
        w = np.asarray(want.column(f"a{j}"), dtype=np.float64)
        if a[0] == "s":
            np.testing.assert_allclose(mat[:, j], w, rtol=1e-9, atol=1e-12, equal_nan=True)
        else:
            np.testing.assert_array_equal(mat[:, j], w)


def test_run_partial_aggregate_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    table = _probe()
    plan = plan_query(parse(AGG_Q), lambda _n: table)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sql_compile.run_partial_aggregate(plan, table)


@pytest.mark.parametrize("n,num", [(0, 0), (1, 1), (7, 3), (5000, 5), (5000, 5000)])
def test_the_sorted_segment_sum_equals_index_add(n, num):
    """The group sums (``segment_reduce`` over the grouping's own sort, the
    one route on every device) against ``index_add_`` into the same slots,
    ``n`` rows in ``num`` key values, a third filtered into the dump slot:
    integer-valued sums exactly, fractional ones within float64 rounding
    of the row-order sums (rtol 1e-12)."""
    rng = np.random.default_rng(n)
    key = torch.from_numpy(rng.integers(0, max(num, 1), n))
    keep = torch.from_numpy(rng.random(n) < 2 / 3)
    segs = sql_compile._segments([(key, "i")], keep)
    if n:
        assert bool((segs.seg[segs.perm].diff() >= 0).all())
        assert torch.equal(segs.offsets.diff(), torch.bincount(segs.seg, minlength=n))
    for vals in (torch.from_numpy(rng.integers(-50, 50, n).astype(np.float64)),
                 torch.from_numpy(rng.normal(size=n) * 1e3)):
        want = torch.zeros(n, dtype=torch.float64).index_add_(0, segs.seg, vals)
        got = sql_compile._segment_sum(segs, vals)
        if bool((vals == vals.round()).all()):
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-9)


# ================================================ view parity
def test_aggregate_views_equal_the_reference_after_every_commit(tmp_path):
    rng = np.random.default_rng(0)
    sink = _sink(tmp_path, _batch(rng, 1))
    reg = ViewRegistry(device=CPU)
    view = reg.register("agg", AGG_Q, sink)
    by_ts = reg.register("by_ts", TS_Q, sink)
    for bid in range(5):
        sink.append_batch(_batch(rng, int(rng.integers(0, 180))), bid)
        reg.maintain(sink, bid)
        _parity(AGG_Q, sink, view, ctx=f"agg batch {bid}")
        _parity(TS_Q, sink, by_ts, ctx=f"ts batch {bid}")
    assert view.describe()["incremental"] and view.describe()["last_applied"] == 4


def test_whole_table_aggregate_and_the_empty_sink(tmp_path):
    rng = np.random.default_rng(1)
    sink = _sink(tmp_path, _batch(rng, 1))
    reg = ViewRegistry(device=CPU)
    q = "SELECT count(*) AS c, sum(f1) AS s, min(f1) AS lo FROM events"
    view = reg.register("tot", q, sink)
    _parity(q, sink, view, ctx="zero batches")
    sink.append_batch(_batch(rng, 0), 0)
    reg.maintain(sink, 0)
    _parity(q, sink, view, ctx="empty batch")
    sink.append_batch(_batch(rng, 120), 1)
    reg.maintain(sink, 1)
    _parity(q, sink, view, ctx="data batch")
    row = reg.register("rows", ROW_Q, _sink(tmp_path, _batch(rng, 1), "empty"))
    _parity(ROW_Q, row.source, row, ctx="row-level over an empty sink")


def test_rowlevel_view_and_its_pinned_read(tmp_path):
    rng = np.random.default_rng(2)
    sink = _sink(tmp_path, _batch(rng, 1))
    reg = ViewRegistry(device=CPU)
    view = reg.register("win", ROW_Q, sink)
    for bid in range(4):
        sink.append_batch(_batch(rng, 150), bid)
        reg.maintain(sink, bid)
        _parity(ROW_Q, sink, view, ctx=f"batch {bid}")
    for upto in (0, 2):
        _parity(ROW_Q, sink, view, upto=upto, ctx=f"pinned {upto}")


def test_maintain_is_idempotent(tmp_path):
    rng = np.random.default_rng(3)
    sink = _sink(tmp_path, _batch(rng, 1))
    reg = ViewRegistry(device=CPU)
    view = reg.register("agg", AGG_Q, sink)
    sink.append_batch(_batch(rng, 100), 0)
    for _ in range(5):
        reg.maintain(sink, 0)
    assert view.applied_rows() == 100
    _parity(AGG_Q, sink, view)


def test_late_row_retraction(tmp_path):
    rng = np.random.default_rng(4)
    sink = _sink(tmp_path, _batch(rng, 1))
    reg = ViewRegistry(device=CPU)
    agg = reg.register("agg", AGG_Q, sink)
    row = reg.register("win", ROW_Q, sink)
    for bid in range(3):
        sink.append_batch(_batch(rng, 80), bid)
        reg.maintain(sink, bid)
    before = _counter("sql.view.retractions")
    sink.append_batch(_batch(rng, 50), 1)            # replay: another row count
    reg.maintain(sink, 1)
    _parity(AGG_Q, sink, agg, ctx="replay (count change)")
    _parity(ROW_Q, sink, row, ctx="replay (count change)")
    sink.append_batch(_batch(rng, 50), 1)            # the same count, other values
    reg.maintain(sink, 1)
    _parity(AGG_Q, sink, agg, ctx="replay (same count)")
    _parity(ROW_Q, sink, row, ctx="replay (same count)")
    assert _counter("sql.view.retractions") > before
    assert agg.applied_rows() == 80 + 50 + 80


def test_watermark_compaction_seals_the_prefix_and_a_replay_below_rebuilds(tmp_path):
    rng = np.random.default_rng(5)
    sink = _sink(tmp_path, _timed_batch(rng, 0))
    wt = WatermarkTracker("t1", 90.0)
    reg = ViewRegistry(device=CPU)
    q = "SELECT i1, count(*) AS c, sum(f1) AS s FROM events GROUP BY i1"
    view = reg.register("agg", q, sink, watermark=wt)
    for bid in range(8):
        tb = _timed_batch(rng, bid)
        wt.filter_late(tb)
        sink.append_batch(tb, bid)
        reg.maintain(sink, bid)
        _parity(q, sink, view, ctx=f"batch {bid}")
    d = view.describe()
    assert d["compacted_upto"] is not None and d["compacted_upto"] >= 3
    assert d["batches_retained"] < 8
    rebuilds = _counter("sql.view.rebuilds")
    sink.append_batch(_timed_batch(rng, 0, n=30), 0)
    reg.maintain(sink, 0)
    _parity(q, sink, view, ctx="sealed replay")
    assert _counter("sql.view.rebuilds") > rebuilds


def test_a_gap_filled_below_the_seal_rebuilds_loudly(tmp_path):
    rng = np.random.default_rng(17)
    sink = _sink(tmp_path, _timed_batch(rng, 0))
    wt = WatermarkTracker("t1", 90.0)
    reg = ViewRegistry(device=CPU)
    q = "SELECT i1, count(*) AS c, sum(f1) AS s FROM events GROUP BY i1"
    view = reg.register("agg", q, sink, watermark=wt)
    for bid in (0, 1, 2, 4, 5, 6, 7):                 # batch 3 never committed
        tb = _timed_batch(rng, bid, n=40)
        wt.filter_late(tb)
        sink.append_batch(tb, bid)
        reg.maintain(sink, bid)
    assert view.describe()["compacted_upto"] >= 4
    rebuilds = _counter("sql.view.rebuilds")
    sink.append_batch(_timed_batch(rng, 3, n=40), 3)
    reg.maintain(sink, 3)
    assert _counter("sql.view.rebuilds") > rebuilds
    _parity(q, sink, view, ctx="gap fill below the seal")
    assert view.applied_rows() == 8 * 40


def test_an_all_nat_batch_does_not_wedge_compaction(tmp_path):
    rng = np.random.default_rng(18)
    sink = _sink(tmp_path, _timed_batch(rng, 0))
    wt = WatermarkTracker("t1", 90.0)
    reg = ViewRegistry(device=CPU)
    q = "SELECT i1, count(*) AS c, sum(f1) AS s FROM events GROUP BY i1"
    view = reg.register("agg", q, sink, watermark=wt)
    for bid in range(6):
        tb = _timed_batch(rng, bid, n=30, nat=(bid == 1))
        if bid != 1:
            wt.filter_late(tb)
        sink.append_batch(tb, bid)
        reg.maintain(sink, bid)
        _parity(q, sink, view, ctx=f"batch {bid}")
    assert view.describe()["compacted_upto"] >= 2


def test_string_group_keys_fold_in_the_interpreter_order(tmp_path):
    """Each batch meets its hospitals in another order; sorted-rank codes
    keep the folded groups in the interpreter's order, the null group
    last, and the canonical keys survive a restart."""
    rng = np.random.default_rng(17)
    pools = (("H02", "H01"), ("H00", "H03", "H01"), ("H03", "H00"))
    sink = _sink(tmp_path, _str_batch(rng, 1, pools[0]))
    reg = ViewRegistry(device=CPU)
    view = reg.register("per_hosp", STR_Q, sink)
    filt = reg.register("per_hosp_busy", STR_WHERE_Q, sink)
    for bid, pool in enumerate(pools):
        sink.append_batch(_str_batch(rng, 80, pool), bid)
        reg.maintain(sink, bid)
        _parity(STR_Q, sink, view, ctx=f"batch {bid}")
        _parity(STR_WHERE_Q, sink, filt, ctx=f"filtered batch {bid}")
    assert view.describe()["incremental"] and filt.describe()["incremental"]
    before = view.read()
    assert before.column("s1").tolist()[-1] is None
    v2 = ViewRegistry(device=CPU).register("per_hosp", STR_Q, sink)
    _parity(STR_Q, sink, v2, ctx="string keys after restart")
    _same(before, v2.read())


# ======================================= fallbacks, explain, the kill switch
@pytest.mark.parametrize("q,reason", [
    ("SELECT f1, sum(f1) OVER (PARTITION BY i1) AS w FROM events", FULL_WINDOW),
    ("SELECT f1 FROM events LIMIT 3", FULL_LIMIT),
    ("SELECT f1 FROM events ORDER BY f1", FULL_NOT_COMPILED),
])
def test_non_incremental_plans_fall_back_loudly_with_the_reference_reasons(tmp_path, q, reason):
    rng = np.random.default_rng(6)
    sink = _sink(tmp_path, _batch(rng, 1))
    sink.append_batch(_batch(rng, 90), 0)
    view = ViewRegistry(device=CPU).register("v", q, sink)
    assert not view.describe()["incremental"]
    assert reason in view.describe()["decisions"]
    jt = J.Table.from_dict({c: sink.read().column(c) for c in sink.read().schema.names})
    assert Psql.explain(q, lambda _n: sink.read())["view_maintenance"] == \
        Jsql.explain(q, lambda _n: jt)["view_maintenance"]
    before = _counter("sql.view.full_recompute")
    _parity(q, sink, view, ctx="fallback")
    assert _counter("sql.view.full_recompute") > before


@pytest.mark.parametrize("q", [AGG_Q, ROW_Q, STR_Q, "SELECT f1 FROM events LIMIT 2",
                               "SELECT f1, count(*) OVER (PARTITION BY i1) AS c FROM events"])
def test_explain_equals_the_reference(tmp_path, q):
    rng = np.random.default_rng(8)
    t = _str_batch(rng, 50, ("H1", "H2"))
    jt = J.Table.from_dict({c: t.column(c) for c in t.schema.names})
    mine, ref = Psql.explain(q, lambda _n: t), Jsql.explain(q, lambda _n: jt)
    assert mine == ref
    assert all(n["incremental"] == DECISION_INCREMENTAL for n in mine["nodes"]) == \
        (mine["view_maintenance"] == "incremental")


def test_the_kill_switch_turns_views_into_full_recomputes(tmp_path, monkeypatch):
    rng = np.random.default_rng(11)
    sink = _sink(tmp_path, _batch(rng, 1))
    reg = ViewRegistry(device=CPU)
    view = reg.register("agg", AGG_Q, sink)
    sink.append_batch(_batch(rng, 60), 0)
    reg.maintain(sink, 0)
    assert view.applied_rows() == 60
    monkeypatch.setenv("CMLHN_SQL_COMPILE", "0")
    sink.append_batch(_batch(rng, 40), 1)
    reg.maintain(sink, 1)
    assert view.applied_rows() == 60                  # no compiled fold
    before = _counter("sql.view.full_recompute")
    _parity(AGG_Q, sink, view, ctx="kill-switch read")
    assert _counter("sql.view.full_recompute") > before
    assert Psql.explain(AGG_Q, lambda _n: sink.read())["view_maintenance"] == \
        [FULL_COMPILE_DISABLED]
    monkeypatch.delenv("CMLHN_SQL_COMPILE")
    _parity(AGG_Q, sink, view, ctx="switch back on")
    assert view.applied_rows() == 100


def test_group_key_dtype_drift_poisons_not_crashes(tmp_path):
    rng = np.random.default_rng(12)
    sink = _sink(tmp_path, _batch(rng, 1))
    reg = ViewRegistry(device=CPU)
    view = reg.register("agg", AGG_Q, sink)
    sink.append_batch(_batch(rng, 50), 0)
    reg.maintain(sink, 0)
    drifted = _batch(rng, 50)
    cols = {c: drifted.column(c) for c in drifted.columns}
    i1 = cols["i1"].astype(np.float64)
    i1[0] = np.nan
    cols["i1"] = i1
    sink.append_batch(P.Table.from_dict(cols), 0)
    reg.maintain(sink, 0)
    d = view.describe()
    assert not d["incremental"] and d["poisoned"]
    _parity(AGG_Q, sink, view, ctx="poisoned still correct")


# =========================================== the dispatcher and the Session
def test_session_sql_serves_from_a_matching_view(tmp_path):
    rng = np.random.default_rng(7)
    s = P.Session(device=CPU)
    try:
        sink = _sink(tmp_path, _batch(rng, 1))
        s.register_table("events", sink)
        sink.append_batch(_batch(rng, 120), 0)
        s.create_view("agg", AGG_Q)
        sink.append_batch(_batch(rng, 90), 1)          # stale until served
        hits = _counter("sql.view.hit")
        out = s.sql(AGG_Q)
        assert Psql.last_dispatch().route == "view"
        assert _counter("sql.view.hit") == hits + 1
        assert compare_tables(_reference(AGG_Q, sink), out) is None
        misses = _counter("sql.view.miss")
        s.sql("SELECT i1, count(*) AS c FROM events GROUP BY i1")
        assert Psql.last_dispatch().route == "compiled"
        assert _counter("sql.view.miss") == misses + 1
        Psql.execute(AGG_Q, s.table, mode="compile", device=CPU)
        assert Psql.last_dispatch().route == "compiled"
        # the host route of sql_to_device reads through the views too
        assert s.views.device.type == "cpu"
    finally:
        s.stop()


def test_create_view_errors_equal_the_reference(tmp_path):
    rng = np.random.default_rng(9)
    mine = P.Session(device=CPU)
    ref = J.Session()
    try:
        sink = _sink(tmp_path, _batch(rng, 1))
        mine.register_table("plain", P.Table.from_dict({"x": [1.0, 2.0]}))
        ref.register_table("plain", J.Table.from_dict({"x": [1.0, 2.0]}))
        mine.register_table("events", sink)
        ref.register_table("events", J.streaming.UnboundedTable(
            str(tmp_path / "jtable"), J.Table.from_dict({"f1": [0.0]}).schema, name="events"))
        for name, q in (("v", "SELECT x FROM plain"),
                        ("v2", "SELECT x FROM (SELECT x FROM plain) q"),
                        ("v3", "SELECT e.f1 FROM events e JOIN plain p ON e.i1 = p.x")):
            with pytest.raises(ValueError) as a:
                mine.create_view(name, q)
            with pytest.raises(ValueError) as b:
                ref.create_view(name, q)
            assert str(a.value) == str(b.value)
        with pytest.raises(ValueError, match="single-table"):
            ViewRegistry(device=CPU).register(
                "v4", "SELECT e.f1 FROM events e JOIN plain p ON e.i1 = p.x", sink)
        mine.create_view("agg", AGG_Q)
        with pytest.raises(ValueError, match="already registered"):
            mine.create_view("agg", AGG_Q)
    finally:
        ref.stop()
        mine.stop()


def test_a_view_serve_failure_falls_through_and_is_counted(tmp_path, monkeypatch):
    rng = np.random.default_rng(15)
    sink = _sink(tmp_path, _batch(rng, 1))
    reg = ViewRegistry(device=CPU)
    reg.register("agg", AGG_Q, sink)
    sink.append_batch(_batch(rng, 40), 0)
    reg.maintain(sink, 0)

    def boom(plan):
        raise RuntimeError("corrupt view state")

    monkeypatch.setattr(reg, "serve_for", boom)
    before = _counter("sql.view.serve_errors")
    out = Psql.execute(AGG_Q, lambda _n: sink.read(), views=reg, device=CPU)
    assert Psql.last_dispatch().route == "compiled"
    assert compare_tables(_reference(AGG_Q, sink), out) is None
    assert _counter("sql.view.serve_errors") == before + 1


def test_the_dispatcher_serve_skips_the_reconcile_when_the_log_is_unchanged(
        tmp_path, monkeypatch):
    rng = np.random.default_rng(14)
    sink = _sink(tmp_path, _batch(rng, 1))
    reg = ViewRegistry(device=CPU)
    reg.register("agg", AGG_Q, sink)
    sink.append_batch(_batch(rng, 80), 0)
    reg.maintain(sink, 0)
    snap = sink.read()
    plan = plan_query(parse(AGG_Q), lambda _n: snap)
    calls = {"n": 0}
    orig = sink.committed_batches

    def counting():
        calls["n"] += 1
        return orig()

    monkeypatch.setattr(sink, "committed_batches", counting)
    for _ in range(5):
        out = reg.serve_for(plan)
        assert out is not None
    assert calls["n"] == 0
    assert compare_tables(_reference(AGG_Q, sink), out) is None
    sink.append_batch(_batch(rng, 20), 1)
    snap2 = sink.read()
    calls["n"] = 0
    out2 = reg.serve_for(plan_query(parse(AGG_Q), lambda _n: snap2))
    assert out2 is not None and calls["n"] == 1
    assert compare_tables(_reference(AGG_Q, sink), out2) is None


def test_a_retraction_rewrites_the_delta_under_a_fresh_path(tmp_path):
    rng = np.random.default_rng(16)
    sink = _sink(tmp_path, _batch(rng, 1))
    reg = ViewRegistry(device=CPU)
    view = reg.register("win", ROW_Q, sink)
    sink.append_batch(_batch(rng, 60), 0)
    reg.maintain(sink, 0)
    first = view._batches[0]["delta_file"]
    sink.append_batch(_batch(rng, 60), 0)
    reg.maintain(sink, 0)
    second = view._batches[0]["delta_file"]
    assert first is not None and second is not None and first != second
    assert sorted(f for f in os.listdir(view.state_dir) if f.startswith("delta-")) == [second]
    v2 = ViewRegistry(device=CPU).register("win", ROW_Q, sink)
    _parity(ROW_Q, sink, v2, ctx="after replay + restart")


def test_views_default_to_the_card_and_raise_without_one(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    sink = _sink(tmp_path, _batch(rng, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ViewRegistry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Psql.execute(AGG_Q, lambda _n: sink.read(), views=ViewRegistry(device=CPU))


# ==================================================== the stream
def _event_csv(path, start_minute, n):
    base = np.datetime64("2025-03-31T22:00:00") + np.timedelta64(start_minute, "m")
    t = P.Table.from_dict({
        "hospital_id": np.array(["H01"] * n, dtype=object),
        "event_time": base + np.arange(n).astype("timedelta64[s]"),
        "admission_count": np.arange(n),
        "current_occupancy": np.full(n, 100),
        "emergency_visits": np.full(n, 5),
        "seasonality_index": np.full(n, 1.0),
        "length_of_stay": np.full(n, 4.0),
    }, P.hospital_event_schema())
    P.write_csv(t, path)


def _stream(root, views):
    incoming = root / "incoming"
    incoming.mkdir(exist_ok=True)
    return incoming, StreamExecution(
        source=FileStreamSource(str(incoming), P.hospital_event_schema()),
        sink=UnboundedTable(str(root / "table"), P.hospital_event_schema()),
        checkpoint=StreamCheckpoint(str(root / "ckpt")),
        views=views, device=CPU,
    )


def test_the_stream_commit_path_maintains_views(tmp_path):
    reg = ViewRegistry(device=CPU)
    incoming, ex = _stream(tmp_path, reg)
    _event_csv(str(incoming / "a.csv"), 0, 30)
    assert ex.run_once().num_appended_rows == 30
    view = reg.register("stats", STATS_Q, ex.sink)
    _event_csv(str(incoming / "b.csv"), 1, 20)
    assert ex.run_once().num_appended_rows == 20
    assert view.applied_rows() == 50                  # folded on the commit path
    _parity(STATS_Q, ex.sink, view)


def test_a_maintenance_failure_is_counted_and_views_catch_up(tmp_path, monkeypatch):
    reg = ViewRegistry(device=CPU)
    incoming, ex = _stream(tmp_path, reg)
    view = reg.register("stats", STATS_Q, ex.sink)

    def fail(*_a, **_k):
        raise OSError("view state disk trouble")

    monkeypatch.setattr(reg, "maintain", fail)
    _event_csv(str(incoming / "a.csv"), 0, 30)
    assert ex.run_once().num_appended_rows == 30      # the batch still commits
    assert ex.metrics.snapshot()["counters"]["stream.view_maintain_errors"] == 1
    assert view.applied_rows() == 0
    _parity(STATS_Q, ex.sink, view)                   # read() catches up
    assert view.applied_rows() == 30


def test_the_session_stream_wires_its_views(tmp_path):
    s = P.Session(device=CPU)
    try:
        incoming = tmp_path / "incoming"
        incoming.mkdir()
        sdf = s.read_stream.schema(P.hospital_event_schema()).csv(str(incoming))
        q = sdf.write_stream.option("checkpointLocation", str(tmp_path / "ckpt")).table("events")
        assert q.execution.views is s.views
        _event_csv(str(incoming / "a.csv"), 0, 25)
        q.process_available()
        view = s.create_view("stats", STATS_Q)
        _event_csv(str(incoming / "b.csv"), 2, 35)
        q.process_available()
        assert view.applied_rows() == 60
        out = s.sql(STATS_Q)
        assert Psql.last_dispatch().route == "view"
        assert int(out.column("c")[0]) == 60
        # sql_to_device's host route (an aggregate) is served by the view
        s.create_view("per_h", "SELECT hospital_id, avg(length_of_stay) AS los,"
                               " sum(admission_count) AS adm FROM events GROUP BY hospital_id")
        s.sql_to_device("SELECT hospital_id, avg(length_of_stay) AS los, sum(admission_count)"
                        " AS adm FROM events GROUP BY hospital_id", feature_cols=["adm"],
                        label_col="los")
        assert Psql.last_dispatch().route == "view"
    finally:
        s.stop()


def test_a_kill_at_view_maintain_resumes_byte_equal(tmp_path):
    def run(root, kill_at_batch=None):
        reg = ViewRegistry(device=CPU)
        incoming, ex = _stream(root, reg)
        view = reg.register("stats", STATS_Q, ex.sink)
        hosp = reg.register("hosp", "SELECT hospital_id, count(*) AS n, avg(length_of_stay)"
                                    " AS los FROM events GROUP BY hospital_id", ex.sink)
        for b in range(4):
            _event_csv(str(incoming / f"f{b}.csv"), b, 20 + b)
            if b == kill_at_batch:
                plan = faults.FaultPlan().crash("sql.view.maintain")
                with faults.active(plan):
                    with pytest.raises(faults.InjectedCrash):
                        ex.run_once()
                assert plan.fired("sql.view.maintain") == 1
                reg = ViewRegistry(device=CPU)          # restart over the same dirs
                incoming, ex = _stream(root, reg)
                view = reg.register("stats", STATS_Q, ex.sink)
                hosp = reg.register("hosp", hosp.query, ex.sink)
                assert ex.run_once() is None            # committed before the kill
            else:
                assert ex.run_once() is not None
        return ex, view, hosp

    (tmp_path / "clean").mkdir()
    (tmp_path / "killed").mkdir()
    _, clean, clean_h = run(tmp_path / "clean")
    ex, killed, killed_h = run(tmp_path / "killed", kill_at_batch=1)
    _same(clean.read(), killed.read())
    _same(clean_h.read(), killed_h.read())
    _parity(STATS_Q, ex.sink, killed, ctx="after resume")


def test_a_replayed_batch_never_applies_twice(tmp_path):
    reg = ViewRegistry(device=CPU)
    incoming, ex = _stream(tmp_path, reg)
    reg.register("stats", STATS_Q, ex.sink)
    _event_csv(str(incoming / "a.csv"), 0, 30)
    assert ex.run_once().num_appended_rows == 30
    _event_csv(str(incoming / "b.csv"), 1, 20)
    plan = faults.FaultPlan().crash("stream.after_sink")
    with faults.active(plan):
        with pytest.raises(faults.InjectedCrash):
            ex.run_once()
    assert plan.fired("stream.after_sink") == 1
    reg2 = ViewRegistry(device=CPU)
    _, ex2 = _stream(tmp_path, reg2)
    view2 = reg2.register("stats", STATS_Q, ex2.sink)
    info = ex2.run_once()
    assert info is not None and info.batch_id == 1
    for _ in range(3):
        reg2.maintain(ex2.sink, 1)
    assert view2.applied_rows() == 50
    assert int(view2.read().column("c")[0]) == 50
    _parity(STATS_Q, ex2.sink, view2, ctx="after replay")


# ============================================ history under a view
def _hist_batch(bid, n=6):
    t1 = (np.datetime64("2025-03-31T22:00:00") + np.timedelta64(bid, "h")
          + np.arange(n).astype("timedelta64[s]")).astype("datetime64[ns]")
    return P.Table.from_dict({"f1": np.arange(n, dtype=np.float64) + bid,
                              "i1": np.arange(n) + bid * 10, "t1": t1})


POLICY = RetentionPolicy(min_seal_batches=2, hot_batches=2, max_segment_batches=3)


def test_views_across_retirement_equal_the_interpreter(tmp_path):
    """Retiring parts into segments changes no view (no rebuild, no
    retraction); a view registered after retirement folds the sealed
    slices; both equal the interpreter on the same snapshot."""
    tbl = _sink(tmp_path, _hist_batch(0, 1))
    reg = ViewRegistry(device=CPU)
    q = "SELECT i1, count(*) AS c, sum(f1) AS s FROM events GROUP BY i1"
    view = reg.register("agg", q, tbl)
    rows = reg.register("rows", "SELECT i1, f1 FROM events WHERE i1 > 12", tbl)
    for bid in range(8):
        tbl.append_batch(_hist_batch(bid), bid)
        reg.maintain(tbl, bid)
    rebuilds0, retract0 = _counter("sql.view.rebuilds"), _counter("sql.view.retractions")
    TableLifecycle(tbl, POLICY).tick()
    reg.maintain(tbl)
    assert _counter("sql.view.rebuilds") == rebuilds0
    assert _counter("sql.view.retractions") == retract0
    _parity(q, tbl, view, ctx="after retirement")
    _parity(rows.query, tbl, rows, ctx="row-level after retirement")
    late = reg.register("agg_late", q, tbl)
    _parity(q, tbl, late, ctx="registered after retirement")
    assert late.applied_rows() == 48


def test_the_missing_part_rule(tmp_path):
    """A missing part that no segment serves is data loss: the view's
    fold raises as the table's read does (the JAX package skips it); a
    retired part served by its segment folds."""
    tbl = _sink(tmp_path, _hist_batch(0, 1))
    for bid in range(6):
        tbl.append_batch(_hist_batch(bid), bid)
    TableLifecycle(tbl, POLICY).tick()                # 0..3 sealed and retired
    reg = ViewRegistry(device=CPU)
    q = "SELECT count(*) AS c, sum(f1) AS s FROM events"
    view = reg.register("tot", q, tbl)
    assert view.applied_rows() == 36
    _parity(q, tbl, view)
    os.remove(os.path.join(tbl.path, "part-0000000005.parquet"))   # a hot part
    with pytest.raises(FileNotFoundError, match="part-0000000005"):
        UnboundedTable(tbl.path, tbl.schema).read()
    with pytest.raises(FileNotFoundError, match="no sealed segment serves it"):
        ViewRegistry(device=CPU).register("tot2", q, tbl)


def test_a_select_star_view_over_an_empty_sink_follows_the_stream_columns(tmp_path):
    """A row-level ``SELECT *`` view registered before the first batch is
    lowered over the declared schema; the stream then adds
    ``ingest_time``.  While its window has no rows the view answers
    with the snapshot's columns, as the interpreter does (the JAX
    package's view keeps the registration's columns there)."""
    incoming = tmp_path / "incoming"
    incoming.mkdir()
    reg = ViewRegistry(device=CPU)
    _, ex = _stream(tmp_path, reg)
    q = ("SELECT * FROM events WHERE event_time BETWEEN '2025-03-31 23:30:00'"
         " AND '2025-03-31 23:59:59'")
    view = reg.register("late_window", q, ex.sink)
    _event_csv(str(incoming / "a.csv"), 0, 30)          # 22:00, outside the window
    assert ex.run_once().num_appended_rows == 30
    got = view.read()
    assert len(got) == 0 and "ingest_time" in got.columns
    _parity(q, ex.sink, view, ctx="empty window")
    _event_csv(str(incoming / "b.csv"), 95, 20)         # 23:35, inside
    ex.run_once()
    _parity(q, ex.sink, view, ctx="window filled")
    assert len(view.read()) == 20


@pytest.mark.parametrize("case", ["strings and nulls", "nan and None", "all null", "empty",
                                  "not all str", "trailing nul", "fixed width",
                                  "over the byte budget"])
def test_string_group_codes_equal_the_object_sort(case, monkeypatch):
    """The partials' string codes (sorted fixed-width unicode where every
    value is a str and the copy fits its byte budget) against the
    per-value Python rule and ``np.unique`` over the objects that they
    replace."""
    rng = np.random.default_rng(3)
    if case == "over the byte budget":   # 3 rows x 40 chars x 4 bytes > 256
        monkeypatch.setattr(sql_compile, "_UNICODE_SORT_BYTES", 256)
    col = {
        "strings and nulls": np.array([["H2", "H10", None, "H1", "é"][i] for i in
                                       rng.integers(0, 5, 200)], object),
        "nan and None": np.array(["b", float("nan"), None, "a", "b"], object),
        "all null": np.array([None, float("nan")], object),
        "empty": np.array([], object),
        "not all str": np.array(["1", 1, None, 2.5, "1"], object),
        "trailing nul": np.array(["a", "a\x00", "b"], object),
        "fixed width": np.array(["x", "yy", "x"]),
        "over the byte budget": np.array(["b" * 40, "a", None, "a"], object),
    }[case]
    if case == "over the byte budget":
        vals = col[[0, 1, 3]]
        assert sql_compile._as_unicode(vals) is vals
    null = np.array([v is None or (isinstance(v, float) and v != v) for v in col], bool)
    if case == "not all str":     # the object sort itself, which cannot order 1 and "1"
        with pytest.raises(TypeError):
            np.unique(col[~null])
        with pytest.raises(TypeError):
            sql_compile.string_group_codes(col)
        return
    uniq, inv = np.unique(col[~null].astype(object), return_inverse=True)
    want = np.full(len(col), len(uniq), dtype=np.int64)
    want[~null] = inv
    codes, got_uniq = sql_compile.string_group_codes(col)
    np.testing.assert_array_equal(codes, want)
    assert [str(u) for u in got_uniq] == [str(u) for u in uniq]

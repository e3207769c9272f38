"""The SQL training window: the port's parser, planner, interpreter and
compiled executor against the JAX package's interpreter, on the CPU.

The JAX package's interpreter (``execute(..., mode="interpret")``) is the
reference here: it runs everywhere, and the JAX fuzz harness pins it equal
to the JAX compiled route.  No test depends on the JAX compiled route.

Tolerances, and why:
- the window query, pass-through columns and the copied interpreter are
  exactly equal (``np.array_equal``; strings and timestamps included):
  the same numpy code, or a row mask and a host gather;
- compiled results that compute (expressions, aggregates, windows) are
  held by the JAX ``sql_fuzz.compare_tables``: null masks exact, floats
  within rtol 1e-9, atol 1e-12 — float64 sums in another order (on the
  card ``index_add_`` adds in atomic order);
- the model stage fed by the window: RMSE at rtol 1e-4 and accuracy
  equal, as ``tests/test_torch_hospital_stage.py`` holds the stage.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.core import sql as Jsql
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.core import sql_fuzz
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.obs import trace as Jtrace
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.obs.registry import (
    global_registry as j_registry,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core import sql as Psql
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core import sql_compile
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.obs import trace as Ptrace
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.obs.registry import (
    global_registry as p_registry,
)

# the suite runs several worker processes on a few cores: one intra-op
# thread per worker keeps torch from oversubscribing them
torch.set_num_threads(1)

CSV = str(Path(__file__).resolve().parents[1] / "data" / "hospital_patients.csv")
DEFAULT_WINDOW = ("2025-03-31 22:00:00", "2025-03-31 23:00:00")
WHOLE_DAY = ("2025-03-31 00:00:00", "2025-03-31 23:59:59")
# the bundled CSV is sorted by event_time: this window holds its first 2,000 rows
FIRST_2000 = ("2025-03-31 00:00:00", "2025-03-31 02:23:24")
EXPLAIN_KEYS = ("route", "fingerprint", "nodes", "fallback", "view_maintenance")


def window_query(win, table="hospital_unbounded_table"):
    return (f"SELECT * FROM {table} WHERE event_time BETWEEN "
            f"'{win[0]}' AND '{win[1]}'")


def port_table(jt):
    """The port's Table over the same numpy columns as a JAX Table."""
    return P.Table.from_dict({c: jt.column(c) for c in jt.schema.names})


def assert_tables_equal(got, want):
    """Same column names, dtypes and values; NaN, NaT and None compare
    equal to themselves."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in want.columns:
        a, b = got.column(c), want.column(c)
        assert a.dtype == b.dtype, c
        if a.dtype == object:
            assert repr(a.tolist()) == repr(b.tolist()), c
        elif a.dtype.kind == "M":
            np.testing.assert_array_equal(a.view(np.int64), b.view(np.int64), err_msg=c)
        else:
            assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), c


@pytest.fixture(scope="module")
def csv_tables():
    jt = J.read_csv(CSV, J.hospital_event_schema(), engine="numpy")
    pt = P.read_csv(CSV, P.hospital_event_schema())
    return jt, pt


# ----------------------------------------------------- the window query
@pytest.mark.parametrize("win", [DEFAULT_WINDOW, WHOLE_DAY], ids=["22-23h", "whole day"])
def test_window_query_compiled_equals_both_interpreters(csv_tables, win):
    jt, pt = csv_tables
    q = window_query(win)
    compiled = Psql.execute(q, lambda _n: pt, device="cpu")
    disp = Psql.last_dispatch()
    assert (disp.route, disp.reasons) == ("compiled", ())
    assert disp.fingerprint == Jsql.explain(q, lambda _n: jt)["fingerprint"]
    interpreted = Psql.execute(q, lambda _n: pt, mode="interpret")
    reference = Jsql.execute(q, lambda _n: jt, mode="interpret")
    assert 0 < len(reference) <= 20_000
    assert_tables_equal(compiled, reference)
    assert_tables_equal(interpreted, reference)


@pytest.mark.parametrize("win", [DEFAULT_WINDOW, WHOLE_DAY], ids=["22-23h", "whole day"])
def test_extract_training_window(csv_tables, win):
    jt, pt = csv_tables
    cfg = P.PipelineConfig(training_window_start=win[0], training_window_end=win[1])
    got = P.extract_training_window(pt, cfg, device="cpu")
    assert Psql.last_dispatch().route == "compiled"
    want = Jsql.execute(window_query(win), lambda _n: jt, mode="interpret").na_drop()
    assert_tables_equal(got, want)
    between = pt.between("event_time", *win).na_drop()
    for c in between.schema.names:
        np.testing.assert_array_equal(got[c], between[c])
    assert got.num_rows == (855 if win == DEFAULT_WINDOW else 20_000)


def test_extract_training_window_needs_ten_rows_and_its_table(csv_tables):
    _, pt = csv_tables
    few = P.PipelineConfig(training_window_start="2025-03-31 00:00:00",
                           training_window_end="2025-03-31 00:00:05")
    with pytest.raises(ValueError, match="training window has only"):
        P.extract_training_window(pt, few, device="cpu")
    # the query names cfg.output_table, and the resolver answers it
    other = P.PipelineConfig(output_table="other", training_window_start=WHOLE_DAY[0],
                             training_window_end=WHOLE_DAY[1])
    assert P.extract_training_window(pt, other, device="cpu").num_rows == 20_000
    assert Psql.last_dispatch().query == window_query(WHOLE_DAY, table="other")


def test_window_reruns_hit_the_device_column_cache(csv_tables):
    _, pt = csv_tables
    table = pt.mask(np.arange(500))          # a fresh Table: an empty cache
    q = window_query(WHOLE_DAY)
    counters = p_registry().collect()["counters"]
    miss0 = counters.get("sql.cache.device.miss", 0)
    hit0 = counters.get("sql.cache.device.hit", 0)
    first = Psql.execute(q, lambda _n: table, device="cpu")
    counters = p_registry().collect()["counters"]
    assert counters["sql.cache.device.miss"] - miss0 == 1   # event_time only
    again = Psql.execute(q, lambda _n: table, device="cpu")
    counters = p_registry().collect()["counters"]
    assert counters["sql.cache.device.miss"] - miss0 == 1
    assert counters["sql.cache.device.hit"] - hit0 == 1
    assert_tables_equal(again, first)
    assert table.device_cache_info() == {"entries": [("event_time", "cpu")], "bytes": 500 * 8}


def test_device_column_representation():
    ts = np.array(["2025-03-31T22:00:00", "NaT"], dtype="datetime64[ns]")
    t = P.Table.from_dict({"f": np.array([1.5, np.nan]), "i": np.array([3, -4]),
                           "b": np.array([True, False]), "t": ts,
                           "s": np.array(["x", None], dtype=object)})
    f, i, b, tt = (t.device_column(c, "cpu") for c in "fibt")
    assert f.dtype == torch.float64 and torch.isnan(f[1]) and f[0] == 1.5
    assert i.dtype == b.dtype == tt.dtype == torch.int64
    assert i.tolist() == [3, -4] and b.tolist() == [1, 0]
    assert tt.tolist() == ts.view(np.int64).tolist()
    assert tt[1] == sql_compile.NAT_SENTINEL == np.iinfo(np.int64).min
    assert t.device_column("f", "cpu") is f
    with pytest.raises(TypeError, match="string columns stay on the host"):
        t.device_column("s", "cpu")


# ------------------------------------------------------------------ fuzz
FUZZ_CASES, FUZZ_QUERIES = 8, 40


@pytest.mark.parametrize("case", range(FUZZ_CASES))
def test_fuzz_compiled_equals_jax_interpreter(case):
    """The JAX harness's random tables and queries (``sql_fuzz``): the
    port's compiled route against the JAX interpreter under the harness's
    own ``compare_tables``; the port's ``explain`` against the JAX one."""
    rng = np.random.default_rng(9_000 + case)
    compared = 0
    for i in range(FUZZ_QUERIES):
        if i % 10 == 0:
            jt = sql_fuzz.random_table(rng)
            pt = port_table(jt)
        q = sql_fuzz.random_query(rng).sql()
        je = Jsql.explain(q, lambda _n: jt)
        pe = Psql.explain(q, lambda _n: pt)
        assert {k: pe.get(k) for k in EXPLAIN_KEYS} == {k: je.get(k) for k in EXPLAIN_KEYS}, q
        try:
            got = Psql.execute(q, lambda _n: pt, mode="compile", device="cpu")
        except Psql.SqlCompileUnsupported:
            assert je["route"] == "interpreter", q
            continue
        except Exception as e:  # the compiled route raised: so must the reference
            with pytest.raises(Exception):
                Jsql.execute(q, lambda _n: jt, mode="interpret")
            assert je["route"] == "compiled", (q, e)
            continue
        assert je["route"] == "compiled", q
        want = Jsql.execute(q, lambda _n: jt, mode="interpret")
        bad = sql_fuzz.compare_tables(want, got)
        assert bad is None, f"{q}: {bad}"
        compared += 1
    assert compared >= FUZZ_QUERIES // 2


EDGE_QUERIES = (
    "SELECT * FROM fuzz WHERE f1 > 0",
    "SELECT f1 * i1 AS e0, coalesce(f1, i2) AS e1, i2 / i1 AS e2 FROM fuzz",
    "SELECT s1, t1, count(*) AS n, avg(f2) AS a, min(i1) AS lo, max(f1) AS hi "
    "FROM fuzz GROUP BY s1, t1",
    "SELECT count(*) AS n, sum(f1) AS s, min(f2) AS lo, max(i2) AS hi FROM fuzz "
    "WHERE t1 IS NOT NULL",
    "SELECT f1, avg(f1) OVER (PARTITION BY i1, f2) AS w FROM fuzz WHERE i2 > 10",
    "SELECT CASE WHEN f1 > 0 THEN i1 WHEN f1 < -5 THEN 2.5 END AS c, abs(-i1) AS a "
    "FROM fuzz LIMIT 3",
    # overlapping branches: the first true one wins
    "SELECT CASE WHEN f1 > 0 THEN 1 WHEN f1 > -5 THEN 2 ELSE 3 END AS c FROM fuzz",
)


@pytest.mark.parametrize("n", [0, 1, 2, 37])
@pytest.mark.parametrize("q", EDGE_QUERIES, ids=[f"q{i}" for i in range(len(EDGE_QUERIES))])
def test_compiled_edge_sizes(q, n):
    """Empty, one-row and tiny tables: whole-table aggregates, the dump
    slot of a filtered GROUP BY, windows and CASE without ELSE."""
    jt = sql_fuzz.random_table(np.random.default_rng(n), n_rows=n)
    pt = port_table(jt)
    got = Psql.execute(q, lambda _n: pt, mode="compile", device="cpu")
    want = Jsql.execute(q, lambda _n: jt, mode="interpret")
    assert sql_fuzz.compare_tables(want, got) is None


@pytest.mark.parametrize("q", [
    "SELECT big FROM t WHERE big > 16777216.5",
    "SELECT big FROM t WHERE big BETWEEN 16777216.5 AND 16777218.5",
    "SELECT big FROM t WHERE big IN (16777217.0, 3)",
    "SELECT big * 0.5 + 0.25 AS h, big - 16777216 AS d, big / 3 AS q FROM t",
    "SELECT coalesce(f, big) AS c FROM t",
])
def test_compiled_int_columns_meet_float_literals_in_float64(q):
    """An int64 column against a float literal compares and computes in
    float64, numpy's promotion: values past 2**24, where float32 would
    round, tell them apart."""
    data = {"big": np.array([16777216, 16777217, 16777218, 16777219, 3]),
            "f": np.array([np.nan, 1.5, np.nan, 0.0, np.nan])}
    jt, pt = J.Table.from_dict(data), P.Table.from_dict(data)
    got = Psql.execute(q, lambda _n: pt, mode="compile", device="cpu")
    want = Jsql.execute(q, lambda _n: jt, mode="interpret")
    assert len(want) > 0
    assert_tables_equal(got, want)


# ------------------------------------------- the interpreter, copied
def _interp_tables():
    rng = np.random.default_rng(5)
    ev = J.read_csv(CSV, J.hospital_event_schema(), engine="numpy").mask(np.arange(300))
    los = ev.column("length_of_stay").copy()
    los[rng.random(300) < 0.05] = np.nan
    events = {c: ev.column(c) for c in ev.schema.names} | {"length_of_stay": los}
    hospitals = {"hospital_id": np.array(["H00-A", "H01-C", "H02-B", "H99-X"], object),
                 "name": np.array(["General", "Mercy", "Childrens", "Closed"], object),
                 "beds": np.array([400, 150, 90, 10])}
    small = {"a": np.array([1.0, np.nan, 3.0, 7.0, np.nan, 6.0]),
             "b": np.array([1, 0, 2, 9, 4, 0]),
             "h": np.array(["x", None, "z", "y", "x", None], object),
             "ts": np.array(["2025-03-31T22:00:00", "NaT", "2025-03-31T22:05:00",
                             "2025-03-31T22:00:00", "NaT", "2025-03-31T23:00:00"],
                            dtype="datetime64[ns]")}
    data = {"events": events, "hospitals": hospitals, "t": small}
    return ({k: J.Table.from_dict(v) for k, v in data.items()},
            {k: P.Table.from_dict(v) for k, v in data.items()})


INTERPRETER_QUERIES = (
    "SELECT * FROM events WHERE event_time BETWEEN '2025-03-31 00:01:00' AND '2025-03-31 00:04:00'",
    "SELECT hospital_id, admission_count FROM events WHERE admission_count > 30 AND current_occupancy <= 300",
    "SELECT * FROM events WHERE (admission_count < 5 OR emergency_visits = 3) AND seasonality_index != 1.0",
    "SELECT hospital_id, COUNT(*) AS n, AVG(length_of_stay) AS m, MIN(current_occupancy) AS lo, "
    "MAX(event_time) AS last FROM events GROUP BY hospital_id",
    "SELECT COUNT(*) AS n, SUM(admission_count) AS s FROM events",
    "SELECT hospital_id, length_of_stay FROM events ORDER BY length_of_stay DESC LIMIT 7",
    "SELECT hospital_id, length_of_stay FROM events ORDER BY event_time LIMIT 5",
    "SELECT AVG(a) AS m, COUNT(a) AS c, SUM(a) AS s FROM t",
    "SELECT h, AVG(a) AS m, COUNT(*) AS n FROM t GROUP BY h",
    "SELECT * FROM t WHERE a != 3",
    "SELECT ts, COUNT(*) AS n FROM t GROUP BY ts",
    "SELECT e.hospital_id, h.name, e.length_of_stay FROM events e JOIN hospitals h "
    "ON e.hospital_id = h.hospital_id",
    "SELECT e.hospital_id, h.name, h.beds FROM events e LEFT JOIN hospitals h "
    "ON e.hospital_id = h.hospital_id",
    "SELECT e.hospital_id, h.name FROM events e FULL OUTER JOIN hospitals h "
    "ON e.hospital_id = h.hospital_id",
    "SELECT h.name, e.admission_count FROM hospitals h RIGHT JOIN events e "
    "ON h.hospital_id = e.hospital_id WHERE e.admission_count > 40",
    "SELECT h.name, AVG(length_of_stay) AS mean_los, COUNT(*) AS n FROM events e JOIN hospitals h "
    "ON e.hospital_id = h.hospital_id GROUP BY h.name HAVING COUNT(*) >= 1 ORDER BY mean_los DESC",
    "SELECT h.name, COUNT(*) AS n FROM events e LEFT JOIN hospitals h "
    "ON e.hospital_id = h.hospital_id GROUP BY h.name",
    "SELECT DISTINCT hospital_id FROM events",
    "SELECT hospital_id, COUNT(*) AS n FROM events GROUP BY hospital_id HAVING AVG(length_of_stay) > 4",
    "SELECT hospital_id FROM events WHERE admission_count > 40 UNION SELECT hospital_id FROM hospitals",
    "SELECT hospital_id FROM events UNION ALL SELECT hospital_id FROM hospitals ORDER BY hospital_id LIMIT 9",
    "SELECT hospital_id FROM events INTERSECT SELECT hospital_id FROM hospitals",
    "SELECT hospital_id FROM hospitals EXCEPT SELECT hospital_id FROM events",
    "SELECT hospital_id, length_of_stay, AVG(length_of_stay) OVER (PARTITION BY hospital_id) AS m FROM events",
    "SELECT hospital_id, event_time, ROW_NUMBER() OVER (PARTITION BY hospital_id ORDER BY event_time) AS rn "
    "FROM events",
    "SELECT admission_count, RANK() OVER (ORDER BY admission_count DESC) AS r, "
    "DENSE_RANK() OVER (ORDER BY admission_count DESC) AS d, NTILE(4) OVER (ORDER BY admission_count) AS q "
    "FROM events",
    "SELECT event_time, LAG(length_of_stay, 2) OVER (PARTITION BY hospital_id ORDER BY event_time) AS prev, "
    "LEAD(length_of_stay) OVER (PARTITION BY hospital_id ORDER BY event_time) AS nxt FROM events",
    "SELECT SUM(admission_count) OVER (PARTITION BY hospital_id ORDER BY event_time) AS run, "
    "FIRST_VALUE(length_of_stay) OVER (PARTITION BY hospital_id ORDER BY event_time) AS f, "
    "LAST_VALUE(length_of_stay) OVER (PARTITION BY hospital_id ORDER BY event_time) AS l FROM events",
    "SELECT CASE WHEN length_of_stay > 5 THEN 'long' WHEN length_of_stay > 2 THEN 'mid' "
    "ELSE 'short' END AS band FROM events",
    "SELECT SUM(CASE WHEN length_of_stay > 5 THEN 1 ELSE 0 END) AS long_stays FROM events",
    "SELECT hospital_id, AVG(CASE WHEN emergency_visits > 10 THEN length_of_stay END) AS er_los "
    "FROM events GROUP BY hospital_id",
    "SELECT CASE WHEN admission_count > 20 THEN 1 ELSE 0 END AS busy, COUNT(*) AS n FROM events "
    "GROUP BY CASE WHEN admission_count > 20 THEN 1 ELSE 0 END",
    "SELECT h FROM t WHERE a IS NULL",
    "SELECT h FROM t WHERE a IS NOT NULL AND b IS NOT NULL",
    "SELECT h FROM t WHERE NOT (a > 5 OR b > 5)",
    "SELECT a FROM t WHERE h IN ('x', 'z')",
    "SELECT h FROM t WHERE a NOT IN (1, 3)",
    "SELECT abs(a) AS x, round(a, 1) AS r, upper(h) AS u, lower(h) AS lo, length(h) AS L, "
    "coalesce(a, b) AS c FROM t",
    "SELECT coalesce(h, 'missing') AS cs FROM t",
    "SELECT a / b AS q, -b AS nb, b * 2 + 1 AS z FROM t",
    "SELECT round(avg(a), 2) AS m FROM t",
    "SELECT hospital_id FROM events WHERE hospital_id IN (SELECT hospital_id FROM hospitals)",
    "SELECT hospital_id FROM hospitals WHERE hospital_id NOT IN (SELECT hospital_id FROM events)",
    "SELECT x.hospital_id, x.n FROM (SELECT hospital_id, COUNT(*) AS n FROM events GROUP BY hospital_id) x "
    "WHERE x.n > 10",
    "SELECT hospital_id, MEDIAN(length_of_stay) AS med, PERCENTILE_APPROX(length_of_stay, 0.9) AS p90 "
    "FROM events GROUP BY hospital_id",
    "SELECT hospital_id, COUNT(*) AS n FROM events GROUP BY hospital_id ORDER BY COUNT(*) DESC, hospital_id",
    # errors: the same exception type and message
    "SELECT FROM events",
    "SELECT SUM(*) FROM events",
    "SELECT * FROM events LIMIT 3 garbage",
    "SELECT hospital_id, COUNT(*) AS n FROM events",
    "SELECT SUM(event_time) FROM events",
    "SELECT abs(a, a) AS x FROM t",
    "SELECT CASE ELSE 1 END AS x FROM t",
    "SELECT CASE WHEN a > 5 THEN 'hi' ELSE 0 END AS x FROM t",
    "SELECT coalesce(h, 1) AS c FROM t",
    "SELECT hospital_id FROM events HAVING COUNT(*) > 1",
    "SELECT * FROM events e JOIN hospitals h ON e.nope = h.hospital_id",
    "SELECT h FROM t WHERE a NOT = 1",
)


@pytest.fixture(scope="module")
def interp_tables():
    return _interp_tables()


@pytest.mark.parametrize("q", INTERPRETER_QUERIES,
                         ids=[f"q{i:02d}" for i in range(len(INTERPRETER_QUERIES))])
def test_interpreter_equals_jax_interpreter(interp_tables, q):
    jtabs, ptabs = interp_tables
    try:
        want = Jsql.execute(q, jtabs.__getitem__, mode="interpret")
    except Exception as e:
        with pytest.raises(type(e)) as got:
            Psql.execute(q, ptabs.__getitem__, mode="interpret")
        assert str(got.value) == str(e)
        return
    got = Psql.execute(q, ptabs.__getitem__, mode="interpret")
    assert_tables_equal(got, want)


# ------------------------------------------------- dispatch bookkeeping
JOIN = ("SELECT e.hospital_id, h.name FROM events e JOIN hospitals h "
        "ON e.hospital_id = h.hospital_id")
SETOP = "SELECT hospital_id FROM events UNION SELECT hospital_id FROM hospitals"


@pytest.mark.parametrize("q", [JOIN, SETOP], ids=["join", "set op"])
def test_compile_mode_refuses_with_the_reference_reasons(interp_tables, q):
    jtabs, ptabs = interp_tables
    with pytest.raises(Jsql.SqlCompileUnsupported) as je:
        Jsql.execute(q, jtabs.__getitem__, mode="compile")
    with pytest.raises(Psql.SqlCompileUnsupported) as pe:
        Psql.execute(q, ptabs.__getitem__, mode="compile", device="cpu")
    assert pe.value.reasons == je.value.reasons and str(pe.value) == str(je.value)
    for name in ("REASON_SETOP", "REASON_JOIN_SUBQUERY", "REASON_DISABLED"):
        assert getattr(Psql, name) == getattr(Jsql, name)
    assert (Psql.explain(q, ptabs.__getitem__) == Jsql.explain(q, jtabs.__getitem__))


def test_kill_switch_routes_to_the_interpreter(interp_tables, csv_tables, monkeypatch):
    jt, pt = csv_tables
    q = window_query(DEFAULT_WINDOW)
    monkeypatch.setenv("CMLHN_SQL_COMPILE", "0")
    je, pe = Jsql.explain(q, lambda _n: jt), Psql.explain(q, lambda _n: pt)
    assert pe == je and pe["route"] == "interpreter"
    assert pe["fallback"] == [Psql.REASON_DISABLED]
    # the compiled route is off, so no card is needed; execute records
    # the route as the reference does, the fused path records the reason
    out = Psql.execute(q, lambda _n: pt)
    want = Jsql.execute(q, lambda _n: jt)
    assert vars(Psql.last_dispatch()) == vars(Jsql.last_dispatch())
    assert Psql.last_dispatch().route == "interpreter"
    assert_tables_equal(out, want)
    assert sql_compile.compile_rowlevel(q, lambda _n: pt, device="cpu") is None
    d = Psql.last_dispatch()
    assert (d.route, d.reasons) == ("interpreter", (Psql.REASON_DISABLED,))


def test_runtime_failure_degrades_visibly_in_auto_and_raises_in_compile(csv_tables, monkeypatch):
    jt, pt = csv_tables
    q = window_query(DEFAULT_WINDOW)

    def boom(*a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(sql_compile, "run_plan", boom)
    out = Psql.execute(q, lambda _n: pt, device="cpu")
    d = Psql.last_dispatch()
    assert d.route == "interpreter"
    assert d.reasons == (("compiled", "runtime fallback: device lost"),)
    assert d.fingerprint == Jsql.explain(q, lambda _n: jt)["fingerprint"]
    assert_tables_equal(out, Jsql.execute(q, lambda _n: jt, mode="interpret"))
    with pytest.raises(RuntimeError, match="device lost"):
        Psql.execute(q, lambda _n: pt, mode="compile", device="cpu")


def test_dispatch_counters_match_the_reference(interp_tables):
    """The interpreter route (a join) moves the same counters by the same
    amounts in both packages; the compiled route counts under
    ``sql.dispatch.compiled`` and the device cache's miss/hit names."""
    jtabs, ptabs = interp_tables

    def delta(reg, run):
        before = dict(reg().collect()["counters"])
        run()
        after = reg().collect()["counters"]
        return {k: after[k] - before.get(k, 0) for k in after
                if k.startswith("sql.") and after[k] != before.get(k, 0)}

    jd = delta(j_registry, lambda: Jsql.execute(JOIN, jtabs.__getitem__))
    pd_ = delta(p_registry, lambda: Psql.execute(JOIN, ptabs.__getitem__, device="cpu"))
    n_reasons = len(Psql.explain(JOIN, ptabs.__getitem__)["fallback"])
    assert pd_ == jd == {"sql.dispatch.interpreter": 1, "sql.fallback_nodes": n_reasons}
    table = ptabs["events"].mask(np.arange(50))
    q = "SELECT length_of_stay * 2 AS x FROM events WHERE admission_count > 3"
    first = delta(p_registry, lambda: Psql.execute(q, lambda _n: table, device="cpu"))
    assert first == {"sql.dispatch.compiled": 1, "sql.cache.device.miss": 2}
    again = delta(p_registry, lambda: Psql.execute(q, lambda _n: table, device="cpu"))
    assert again == {"sql.dispatch.compiled": 1, "sql.cache.device.hit": 2}


def test_query_span_notes_match_the_reference(interp_tables, csv_tables):
    jtabs, ptabs = interp_tables
    _, pt = csv_tables
    spans = {}
    for name, trace, run in (
        ("jax", Jtrace, lambda: Jsql.execute(JOIN, jtabs.__getitem__)),
        ("port", Ptrace, lambda: Psql.execute(JOIN, ptabs.__getitem__, device="cpu")),
    ):
        with trace.active(trace.Tracer()) as tr:
            run()
        spans[name] = [(s["name"], s["attrs"]) for s in tr.spans]
    assert spans["port"] == spans["jax"] == [("sql.query", {"route": "interpreter"})]
    q = window_query(DEFAULT_WINDOW)
    with Ptrace.active(Ptrace.Tracer()) as tr:
        Psql.execute(q, lambda _n: pt, device="cpu")
    fp = Psql.explain(q, lambda _n: pt)["fingerprint"]
    assert [(s["name"], s["attrs"]) for s in tr.spans] == [
        ("sql.query", {"route": "compiled", "fingerprint": fp})]


# ------------------------------------------ the window feeding the stage
DEPTH, TREES = 3, 3


def _jax_stage(table, mesh):
    """§6–§10 of the JAX ``_run``, in its order."""
    assembler = J.VectorAssembler(J.FEATURE_COLS)
    binarizer = J.Binarizer(J.LABEL_COL, "LOS_binary", 5.0)
    train_t, test_t = J.train_test_split(binarizer.transform(table), 0.7, 42)
    train, test = assembler.transform(train_t), assembler.transform(test_t)
    reg_eval = J.RegressionEvaluator("rmse", label_col=J.LABEL_COL)
    rmse, acc = {}, {}
    for name, est in {
        "LinearRegression": J.LinearRegression(),
        "DecisionTreeRegressor": J.DecisionTreeRegressor(max_depth=DEPTH),
        "RandomForestRegressor": J.RandomForestRegressor(max_depth=DEPTH, num_trees=TREES),
    }.items():
        m = est.fit(train, label_col=J.LABEL_COL, mesh=mesh)
        rmse[name] = reg_eval.evaluate(m.transform(test, label_col=J.LABEL_COL, mesh=mesh))
    cls_eval = J.MulticlassClassificationEvaluator("accuracy", label_col="LOS_binary")
    for name, est in {
        "DecisionTreeClassifier": J.DecisionTreeClassifier(max_depth=DEPTH),
        "RandomForestClassifier": J.RandomForestClassifier(max_depth=DEPTH, num_trees=TREES),
    }.items():
        m = est.fit(train, label_col="LOS_binary", mesh=mesh)
        acc[name] = cls_eval.evaluate(m.transform(test, label_col="LOS_binary", mesh=mesh))
    return rmse, acc


def test_window_feeds_the_model_stage(csv_tables, mesh1):
    jt, pt = csv_tables
    cfg = P.PipelineConfig(training_window_start=FIRST_2000[0],
                           training_window_end=FIRST_2000[1],
                           tree_max_depth=DEPTH, rf_num_trees=TREES)
    window = P.extract_training_window(pt, cfg, device="cpu")
    jwindow = Jsql.execute(window_query(FIRST_2000), lambda _n: jt, mode="interpret").na_drop()
    assert window.num_rows == jwindow.num_rows == 2000
    assert_tables_equal(window, jwindow)
    res = P.run_model_stage(window, cfg, device="cpu")
    rmse, acc = _jax_stage(jwindow, mesh1)
    assert res.training_rows == 2000
    for name, v in rmse.items():
        np.testing.assert_allclose(res.regression_rmse[name], v, rtol=1e-4)
    assert res.classification_accuracy == acc

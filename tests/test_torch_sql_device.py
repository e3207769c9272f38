"""The port's fused SQL-to-device path (``Session.sql_to_device``,
``DeviceView.assemble``, ``VectorAssembler.transform_device``,
``compact_dataset``) against the JAX package's host route, on the CPU.

The reference here is the JAX package's HOST route: its interpreter
(``execute(mode="interpret")``), ``na_drop`` over the feature and label
columns, ``VectorAssembler`` and the float32 cast of ``device_dataset``.
Its own fused path is held equal to that route by its tests
(``tests/test_sql_device.py::test_fused_assemble_matches_host_path``),
and unlike that path it runs on every jax version (its fused assembly
needs ``jax.experimental.enable_x64``).

Tolerances, and why:
- the valid rows of x and y, and their count, are equal: both routes
  evaluate the query in float64 (the compiled torch ops are held to the
  interpreter exactly by ``tests/test_torch_sql.py``) and cast the same
  float64 / int64 values to float32 once;
- LinearRegression on the fused dataset against the JAX package's fit
  on its host route: coefficients within 1e-4 of the largest (the
  float32 normal equations of hospital-scale features, ROADMAP queue 3);
- the compaction keeps rows, order and weights exactly (a gather).
"""

import contextlib

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.core import sql as jsql
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core import sql as psql
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core.sql_compile import (
    compact_dataset,
    compile_rowlevel,
)

torch.set_num_threads(1)

LR_TOL = 1e-4

# bench.py's sql_device query: the paper's window and the derived
# features a Spark user adds (CASE, abs, a ratio)
QUERY = (
    "SELECT admission_count, current_occupancy, emergency_visits, seasonality_index,"
    " CASE WHEN seasonality_index > 0.5 THEN 1.0 ELSE 0.0 END AS peak_season,"
    " abs(current_occupancy - 250) AS occ_dev,"
    " (emergency_visits / (admission_count + 1)) AS er_ratio,"
    " length_of_stay"
    " FROM events WHERE event_time BETWEEN"
    " '2025-03-31 22:00:00' AND '2025-03-31 23:55:00'"
)
FEATS = ("admission_count", "current_occupancy", "emergency_visits", "seasonality_index",
         "peak_season", "occ_dev", "er_ratio")
LABEL = "length_of_stay"


def _columns(n=4000, seed=0, nan=True):
    """bench.py's sql_device table (8 hospitals, events over 2 h), with
    NaN in a float feature and in the label for ``na_drop`` to drop."""
    rng = np.random.default_rng(seed)
    cols = {
        "hospital_id": np.array([f"H{i % 8:02d}" for i in range(n)], object),
        "event_time": (np.datetime64("2025-03-31T22:00:00")
                       + rng.integers(0, 7200, n).astype("timedelta64[s]")
                       ).astype("datetime64[ns]"),
        "admission_count": rng.integers(0, 50, n),
        "current_occupancy": rng.integers(10, 500, n),
        "emergency_visits": rng.integers(0, 30, n),
        "seasonality_index": rng.random(n),
        "length_of_stay": rng.gamma(3.0, 1.5, n),
    }
    if nan:
        cols["seasonality_index"][rng.random(n) < 0.03] = np.nan
        cols["length_of_stay"][rng.random(n) < 0.02] = np.nan
    return cols


@pytest.fixture
def session():
    s = P.Session(device="cpu")
    s.register_table("events", P.Table.from_dict(_columns()))
    yield s
    s.stop()


def _jax_host_route(query, feats=FEATS, label=LABEL, cols=None):
    """The JAX package's host route: interpreter → na_drop → assembler,
    as float32 rows."""
    t = J.Table.from_dict(cols if cols is not None else _columns())
    out = jsql.execute(query, lambda _n: t, mode="interpret")
    out = out.na_drop(subset=list(feats) + ([label] if label else []))
    asm = J.VectorAssembler(feats).transform(out)
    y = asm.label(label).astype(np.float32) if label else None
    return asm, asm.features.astype(np.float32), y


class _Clock:
    def __init__(self):
        self.names = []

    @contextlib.contextmanager
    def stage(self, name):
        self.names.append(name)
        yield


def test_window_query_compiles_with_no_fallback(session):
    ex = session.sql_explain(QUERY)
    assert ex["route"] == "compiled" and ex["fallback"] == []
    assert J.core.sql.explain(QUERY, lambda _n: J.Table.from_dict(_columns()))["route"] == \
        "compiled"


def test_fused_rows_equal_the_jax_host_route(session):
    clock = _Clock()
    ds = session.sql_to_device(QUERY, feature_cols=FEATS, label_col=LABEL, clock=clock)
    d = psql.last_dispatch()
    assert d.route == "compiled" and d.reasons == ()
    assert {"transfer", "sql", "assemble"} <= set(clock.names)
    _, jx, jy = _jax_host_route(QUERY)
    w = ds.w.numpy()
    valid = w > 0
    assert ds.n_padded == 4000                     # the view's true row count
    assert float(ds.count()) == valid.sum() == len(jx)
    np.testing.assert_array_equal(ds.x.numpy()[valid], jx)
    np.testing.assert_array_equal(ds.y.numpy()[valid], jy)
    assert ds.x.dtype == ds.y.dtype == ds.w.dtype == torch.float32
    assert set(np.unique(w)) == {0.0, 1.0}


def test_na_drop_rows_stay_in_place_zeroed():
    n = 64
    rng = np.random.default_rng(0)
    f = rng.normal(size=n)
    f[::7] = np.nan
    y = rng.normal(size=n)
    y[::11] = np.nan
    cols = {"a": f, "b": rng.integers(0, 9, n), "y": y}
    s = P.Session(device="cpu")
    s.register_table("tt", P.Table.from_dict(cols))
    try:
        ds = s.sql_to_device("SELECT * FROM tt", feature_cols=("a", "b"), label_col="y")
        x, w, yy = ds.x.numpy(), ds.w.numpy(), ds.y.numpy()
        keep = ~np.isnan(f) & ~np.isnan(y)
        np.testing.assert_array_equal(w, keep.astype(np.float32))
        assert np.all(np.isfinite(x)) and np.all(x[w == 0] == 0) and np.all(yy[w == 0] == 0)
        _, jx, jy = _jax_host_route("SELECT * FROM tt", ("a", "b"), "y", cols)
        np.testing.assert_array_equal(x[w > 0], jx)
        np.testing.assert_array_equal(yy[w > 0], jy)
        # without na_drop every row is valid and a NaN stays a NaN
        raw = s.sql_to_device("SELECT * FROM tt", feature_cols=("a", "b"), label_col="y",
                              na_drop=False)
        assert float(raw.count()) == n
        np.testing.assert_array_equal(raw.x.numpy()[:, 0], f.astype(np.float32))
    finally:
        s.stop()


def test_linear_regression_on_the_fused_rows_matches_jax(session):
    ds = session.sql_to_device(QUERY, feature_cols=FEATS, label_col=LABEL)
    pm = P.LinearRegression().fit(ds)
    asm, _, _ = _jax_host_route(QUERY)
    jm = J.LinearRegression().fit(asm, label_col=LABEL)
    pt = np.r_[pm.coefficients.numpy(), float(pm.intercept)]
    jt = np.r_[np.asarray(jm.coefficients), float(jm.intercept)]
    assert np.abs(pt - jt).max() <= LR_TOL * np.abs(jt).max()


def test_compaction_keeps_rows_order_and_weights(session):
    view = compile_rowlevel(QUERY, session.table, device="cpu")
    asm = P.VectorAssembler(FEATS)
    full = asm.transform_device(view, label_col=LABEL)
    small = asm.transform_device(view, label_col=LABEL, compact=True)
    valid = full.w.numpy() > 0
    assert small.n_padded == valid.sum()            # exactly n_valid rows, no bucket
    np.testing.assert_array_equal(small.x.numpy(), full.x.numpy()[valid])
    np.testing.assert_array_equal(small.y.numpy(), full.y.numpy()[valid])
    np.testing.assert_array_equal(small.w.numpy(), full.w.numpy()[valid])
    _, jx, jy = _jax_host_route(QUERY)
    np.testing.assert_array_equal(small.x.numpy(), jx)
    # with weights other than 1 and nothing valid
    x, y = full.x[:6], full.y[:6]
    w = torch.tensor([0.0, 2.0, 0.0, 0.5, 1.0, 0.0])
    cx, cy, cw = compact_dataset(x, y, w)
    np.testing.assert_array_equal(cw.numpy(), [2.0, 0.5, 1.0])
    np.testing.assert_array_equal(cx.numpy(), x.numpy()[[1, 3, 4]])
    ex, ey, ew = compact_dataset(x, y, torch.zeros(6))
    assert ex.shape == (1, len(FEATS)) and float(ew.sum()) == 0 and torch.all(ex == 0)


@pytest.mark.parametrize("query", [
    # a string predicate: the row-level plan falls back to the interpreter
    "SELECT * FROM events WHERE hospital_id = 'H00'",
    # a string GROUP BY: an aggregate cannot fuse; the host route runs it
    "SELECT hospital_id, AVG(admission_count) AS admission_count, "
    "AVG(current_occupancy) AS current_occupancy, AVG(emergency_visits) AS emergency_visits, "
    "AVG(seasonality_index) AS seasonality_index, AVG(length_of_stay) AS length_of_stay "
    "FROM events GROUP BY hospital_id",
])
def test_host_route_outside_the_subset_equals_jax(session, query):
    assert compile_rowlevel(query, session.table, device="cpu") is None
    ds = session.sql_to_device(query)
    feats = tuple(P.FEATURE_COLS)
    _, jx, jy = _jax_host_route(query, feats, LABEL)
    assert ds.n_padded == len(jx) and float(ds.count()) == len(jx)
    if "GROUP BY" in query:
        # the compiled aggregate's float64 sums add in another order
        np.testing.assert_allclose(ds.x.numpy(), jx, rtol=1e-7)
        np.testing.assert_allclose(ds.y.numpy(), jy, rtol=1e-7)
    else:
        assert psql.last_dispatch().route == "interpreter"
        np.testing.assert_array_equal(ds.x.numpy(), jx)
        np.testing.assert_array_equal(ds.y.numpy(), jy)


def test_mode_compile_raises_where_jax_raises(session):
    q = "SELECT * FROM events WHERE hospital_id = 'H00'"
    with pytest.raises(psql.SqlCompileUnsupported, match="string column") as got:
        session.sql_to_device(q, mode="compile")
    jt = J.Table.from_dict(_columns())
    with pytest.raises(jsql.SqlCompileUnsupported) as want:
        jsql.execute(q, lambda _n: jt, mode="compile")
    assert str(got.value) == str(want.value)
    # mode="interpret" takes the host route; its rows are the fused ones
    fused = session.sql_to_device(QUERY, feature_cols=FEATS, label_col=LABEL)
    host = session.sql_to_device(QUERY, feature_cols=FEATS, label_col=LABEL, mode="interpret")
    valid = fused.w.numpy() > 0
    np.testing.assert_array_equal(host.x.numpy(), fused.x.numpy()[valid])


def test_assemble_refuses_what_jax_refuses(session):
    view = compile_rowlevel("SELECT * FROM events", session.table, device="cpu")
    with pytest.raises(TypeError, match="not numeric"):
        view.assemble(("hospital_id",))
    with pytest.raises(TypeError, match="not numeric"):
        view.assemble(("admission_count",), label_col="event_time")
    with pytest.raises(KeyError, match="not an output column"):
        view.assemble(("nope",))
    # no label: y is zeros, and the default label is length_of_stay
    x, y, w = view.assemble(("admission_count",))
    assert torch.all(y == 0) and x.shape == (4000, 1)
    ds = P.VectorAssembler(("admission_count",)).transform_device(view)
    assert float(ds.y.abs().sum()) > 0


def test_empty_result_keeps_one_pad_row():
    s = P.Session(device="cpu")
    s.register_table("events", P.Table.from_dict(_columns(50)))
    try:
        q = QUERY.replace("23:55:00", "21:00:00").replace("22:00:00", "20:00:00")
        for compact in (False, True):
            view = compile_rowlevel(q, s.table, device="cpu")
            ds = P.VectorAssembler(FEATS).transform_device(view, label_col=LABEL,
                                                           compact=compact)
            assert float(ds.count()) == 0 and ds.n_padded == (1 if compact else 50)
    finally:
        s.stop()

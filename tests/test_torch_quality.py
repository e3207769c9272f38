"""The port's ``quality/`` against the JAX package's, on the CPU.

Sketches, profiles and PSI, the row validators, header reconciliation,
the drift monitor's window / trip sequence, the input guard and the
salvage CSV parser: the same numpy inputs, made from a seed, go through
both packages.  Every comparison is ``==`` (no tolerance): both packages
run the same float64 numpy arithmetic in the same order on the host.
"""

import json

import numpy as np
import pytest

from clustermachinelearningforhospitalnetworks_apache_spark_tpu import quality as JQ
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.core import schema as JS
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.core.table import Table as JTable
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.io import csv as JCSV
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import quality as PQ
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core import schema as PS
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core.table import (
    Table as PTable,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.io import csv as PCSV

NAMES = ("admission_count", "current_occupancy", "emergency_visits", "seasonality_index")


def _column(kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(3.0, 2.0, 5000)
    if kind == "non_finite":
        v = rng.normal(0.0, 1.0, 3000)
        v[rng.choice(3000, 60, replace=False)] = np.nan
        v[:3] = [np.inf, -np.inf, np.inf]
        return v
    if kind == "constant":
        return np.full(700, 4.25)
    if kind == "integers":
        return rng.poisson(3.0, 4000).astype(np.float64)
    if kind == "heavy_tail":
        return rng.lognormal(0.0, 2.0, 4000)
    raise ValueError(kind)


KINDS = ("normal", "non_finite", "constant", "integers", "heavy_tail")


def _same_sketch(a, b) -> None:
    assert np.array_equal(a.edges, b.edges)
    assert np.array_equal(a.counts, b.counts)
    for f in ("count", "mean", "m2", "min", "max", "n_invalid"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.std == b.std


def _same_profile(a, b) -> None:
    assert a.names == b.names
    for n in a.names:
        _same_sketch(a.sketches[n], b.sketches[n])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bins", [4, 16])
def test_sketch_update_and_quantiles_equal(kind, bins):
    v = _column(kind, 1)
    js = JQ.FeatureSketch(edges=JQ.sketches._edges_from_values(v, bins))
    ps = PQ.FeatureSketch(edges=PQ.sketches._edges_from_values(v, bins))
    for part in np.array_split(v, 7):   # several updates: the Chan merge
        js.update(part)
        ps.update(part)
    _same_sketch(js, ps)
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0):
        a, b = js.approx_quantile(q), ps.approx_quantile(q)
        assert a == b or (np.isnan(a) and np.isnan(b))


@pytest.mark.parametrize("kind", KINDS)
def test_sketch_merge_and_dict_round_trip_cross_packages(kind):
    v = _column(kind, 2)
    edges = JQ.sketches._edges_from_values(v, 16)
    ja, jb = JQ.FeatureSketch(edges=edges).update(v[:1000]), JQ.FeatureSketch(edges=edges)
    pa, pb = PQ.FeatureSketch(edges=edges).update(v[:1000]), PQ.FeatureSketch(edges=edges)
    jb.update(v[1000:])
    pb.update(v[1000:])
    _same_sketch(ja.merge(jb), pa.merge(pb))
    jd, pd = ja.to_dict(), pa.to_dict()
    assert json.dumps(jd) == json.dumps(pd)
    # each package reads the other's dict back to the same sketch
    _same_sketch(JQ.FeatureSketch.from_dict(pd), PQ.FeatureSketch.from_dict(jd))
    with pytest.raises(ValueError, match="different bin edges"):
        PQ.FeatureSketch(edges=edges).merge(PQ.FeatureSketch(edges=edges * 2 + 1))


@pytest.mark.parametrize("shift", [0.0, 0.1, 0.5, 2.0, 50.0])
@pytest.mark.parametrize("eps", [None, 1e-6])
def test_psi_equal(shift, eps):
    rng = np.random.default_rng(3)
    ref, live = rng.normal(0, 1, 8000), rng.normal(shift, 1, 300)
    edges = JQ.sketches._edges_from_values(ref, 16)
    jr, jl = JQ.FeatureSketch(edges=edges).update(ref), JQ.FeatureSketch(edges=edges).update(live)
    pr, pl = PQ.FeatureSketch(edges=edges).update(ref), PQ.FeatureSketch(edges=edges).update(live)
    got = PQ.population_stability_index(pr, pl, eps)
    assert got == JQ.population_stability_index(jr, jl, eps)
    assert PQ.population_stability_index(pr, PQ.FeatureSketch.like(pr)) == 0.0


@pytest.mark.parametrize("seed,n_rows", [(0, 3000), (1, 3000), (2, 3000), (7, (1 << 16) + 3)])
def test_profile_from_matrix_psi_merge_equal(seed, n_rows):
    """The port sketches each column on a thread of its own: the same
    float64 operations a column, so ``==`` at every size."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_rows, 4)) * [1.0, 10.0, 0.1, 3.0] + [0, 100, 1, -5]
    x[rng.random(x.shape) < 0.01] = np.nan
    x[rng.random(x.shape) < 0.001] = np.inf
    jp, pp = JQ.DataProfile.from_matrix(x, NAMES), PQ.DataProfile.from_matrix(x, NAMES)
    _same_profile(jp, pp)
    assert jp.total_rows == pp.total_rows
    live = x[:500] + [0.0, 25.0, 0.0, 0.0]
    jl, pl = JQ.DataProfile.like(jp).update_matrix(live), PQ.DataProfile.like(pp).update_matrix(
        live)
    assert jp.psi_against(jl) == pp.psi_against(pl)
    _same_profile(jl.merge(JQ.DataProfile.like(jp).update_matrix(x[500:900])),
                  pl.merge(PQ.DataProfile.like(pp).update_matrix(x[500:900])))
    assert json.dumps(jp.to_dict()) == json.dumps(pp.to_dict())
    _same_profile(PQ.DataProfile.from_dict(jp.to_dict()), JQ.DataProfile.from_dict(pp.to_dict()))
    with pytest.raises(ValueError, match="does not match"):
        PQ.DataProfile.from_matrix(x, NAMES[:3])


# ------------------------------------------------------------- validators
def _events(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    t0 = np.datetime64("2025-03-31T08:00:00", "ns")
    cols = {
        "hospital_id": np.array([f"H{i}" for i in rng.integers(0, 4, n)], dtype=object),
        "event_time": t0 + (np.arange(n) * 60_000_000_000).astype("timedelta64[ns]"),
        "admission_count": rng.integers(0, 50, n).astype(np.float64),
        "current_occupancy": rng.integers(0, 900, n).astype(np.float64),
        "emergency_visits": rng.integers(0, 40, n).astype(np.float64),
        "seasonality_index": rng.uniform(0.5, 1.5, n),
        "length_of_stay": rng.uniform(1.0, 12.0, n),
    }
    # plant: out of range, ±inf, NaN (passes), null id, null time, time
    # running backwards, a value outside a domain
    cols["admission_count"][3] = 20_000
    cols["current_occupancy"][5] = -1
    cols["seasonality_index"][7] = np.inf
    cols["length_of_stay"][9] = -np.inf
    cols["length_of_stay"][11] = 400.0
    cols["emergency_visits"][13] = np.nan
    cols["hospital_id"][15] = None
    cols["hospital_id"][16] = ""
    cols["event_time"][17] = np.datetime64("NaT")
    cols["event_time"][19] = t0 - np.timedelta64(5, "h")
    cols["hospital_id"][21] = "H9"
    return cols


def _tables(cols: dict):
    return (JTable.from_dict(cols, JS.hospital_event_schema()),
            PTable.from_dict(cols, PS.hospital_event_schema()))


def _same_table(a, b) -> None:
    assert a.schema.names == b.schema.names and len(a) == len(b)
    for n in a.schema.names:
        x, y = a.columns[n], b.columns[n]
        assert x.dtype == y.dtype, n
        if x.dtype.kind == "f":
            assert np.array_equal(x, y, equal_nan=True), n
        elif x.dtype.kind == "M":
            assert np.array_equal(x.view("i8"), y.view("i8")), n
        else:
            assert list(x) == list(y), n


def _constraint_sets(pkg):
    cs = pkg.hospital_constraints()
    full = (pkg.hospital_constraints()
            .domain("hospital_id", ["H0", "H1", "H2", "H3"])
            .monotone("event_time", group_by="hospital_id"))
    return {"default": cs, "full": full,
            "ungrouped_monotone": pkg.ConstraintSet().monotone("event_time"),
            "none": None}


@pytest.mark.parametrize("which", ["default", "full", "ungrouped_monotone", "none"])
@pytest.mark.parametrize("seed", [0, 1])
def test_validator_masks_and_reject_records_equal(which, seed):
    jt, pt = _tables(_events(60, seed))
    jv = JQ.RowValidator(JS.hospital_event_schema(), _constraint_sets(JQ)[which])
    pv = PQ.RowValidator(PS.hospital_event_schema(), _constraint_sets(PQ)[which])
    assert [c.reason for c in jv.constraints] == [c.reason for c in pv.constraints]
    jr, pr = jv.validate(jt), pv.validate(pt)
    _same_table(jr.accepted, pr.accepted)
    _same_table(jr.rejected, pr.rejected)
    assert jr.reasons == pr.reasons and jr.histogram == pr.histogram
    assert (jr.n_input, jr.n_rejected) == (pr.n_input, pr.n_rejected)
    assert jr.reject_records("f.csv") == pr.reject_records("f.csv")
    if which == "default":
        assert pr.n_rejected == 8    # rows 3, 5, 7, 9, 11, 15, 16, 17


def test_validator_non_nullable_schema_field_and_empty_table():
    jsch = JS.Schema([JS.Field("a", JS.FLOAT, nullable=False), ("b", JS.STRING)])
    psch = PS.Schema([PS.Field("a", PS.FLOAT, nullable=False), ("b", PS.STRING)])
    cols = {"a": np.array([1.0, np.nan, 3.0]), "b": np.array(["x", None, "z"], dtype=object)}
    jr = JQ.RowValidator(jsch).validate(JTable.from_dict(cols, jsch))
    pr = PQ.RowValidator(psch).validate(PTable.from_dict(cols, psch))
    assert jr.reasons == pr.reasons == [["null:a"]]
    _same_table(jr.accepted, pr.accepted)
    je = JQ.RowValidator(jsch).validate(JTable.from_dict(cols, jsch).limit(0))
    pe = PQ.RowValidator(psch).validate(PTable.from_dict(cols, psch).limit(0))
    assert (je.n_input, je.histogram) == (pe.n_input, pe.histogram) == (0, {})


# -------------------------------------------------------------- reconcile
HEADERS = {
    "exact": ["hospital_id", "event_time", "admission_count", "current_occupancy",
              "emergency_visits", "seasonality_index", "length_of_stay"],
    "reordered": ["event_time", "hospital_id", "length_of_stay", "admission_count",
                  "current_occupancy", "emergency_visits", "seasonality_index"],
    "alias_rename": ["hospital_id", "event_time", "admits", "current_occupancy",
                     "emergency_visits", "seasonality_index", "los"],
    "normalized_rename": ["Hospital-ID", "EVENT_TIME", "admission count", "currentOccupancy",
                          "emergency_visits", "seasonality_index", "length_of_stay"],
    "missing_and_added": ["hospital_id", "event_time", "admission_count", "ward",
                          "emergency_visits", "length_of_stay", "extra"],
    "duplicates": ["hospital_id", "hospital_id", "event_time", "admission_count",
                   "current_occupancy", "emergency_visits", "seasonality_index",
                   "length_of_stay"],
    "empty": [],
}
ALIASES = {"admits": "admission_count", "los": "length_of_stay"}


@pytest.mark.parametrize("header", sorted(HEADERS))
def test_reconcile_columns_equal(header):
    jm = JQ.reconcile_columns(HEADERS[header], JS.hospital_event_schema(), ALIASES, "h7.csv")
    pm = PQ.reconcile_columns(HEADERS[header], PS.hospital_event_schema(), ALIASES, "h7.csv")
    assert jm.indices == pm.indices
    assert [e.to_dict() for e in jm.events] == [e.to_dict() for e in pm.events]
    assert (jm.exact, jm.missing) == (pm.exact, pm.missing)


# ------------------------------------------------------------------ drift
def _monitor_pair(window: int, trip_after: int, threshold: float = JQ.PSI_DRIFT):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4000, 4)) * [5.0, 80.0, 4.0, 0.2] + [20, 400, 10, 1]
    jp, pp = JQ.DataProfile.from_matrix(x, NAMES), PQ.DataProfile.from_matrix(x, NAMES)
    return (JQ.DriftMonitor(jp, threshold, window, trip_after),
            PQ.DriftMonitor(pp, threshold, window, trip_after), x)


@pytest.mark.parametrize("window,trip_after", [(64, 1), (256, 3), (100, 2), (16, 3)])
def test_drift_monitor_window_and_trip_sequence_equal(window, trip_after):
    jm, pm, x = _monitor_pair(window, trip_after)
    rng = np.random.default_rng(6)
    shift = np.array([0.0, 160.0, 0.0, 0.0])
    seq_j, seq_p = [], []
    for step in range(80):
        n = int(rng.integers(1, 100))
        rows = x[rng.integers(0, len(x), n)] + (shift if 20 <= step < 45 else 0.0)
        for m, seq in ((jm, seq_j), (pm, seq_p)):
            m.observe(rows)
            seq.append((m.should_trip(), m.max_psi, m.drifting, m.scores(), m.snapshot()))
        if step == 60:   # the promotion: a new reference
            jm.rebase(JQ.DataProfile.from_matrix(x + shift, NAMES))
            pm.rebase(PQ.DataProfile.from_matrix(x + shift, NAMES))
    assert seq_j == seq_p
    assert (jm.trips, jm.rebases) == (pm.trips, pm.rebases) and pm.trips >= 1
    with pytest.raises(ValueError):
        PQ.DriftMonitor(pm.reference, window_rows=0)


GUARD_CASES = ("clean", "non_finite", "ranged", "mixed_1d", "width_mismatch")


def _guard_input(case: str, x: np.ndarray) -> np.ndarray:
    rows = x[:40].copy()
    if case == "non_finite":
        rows[3, 1], rows[7, 0], rows[7, 2] = np.nan, np.inf, -np.inf
    elif case == "ranged":
        rows[2, 1] += 1e6
        rows[9, 3] = -1e4
    elif case == "mixed_1d":
        rows = rows[0].copy()
        rows[1], rows[2] = np.nan, 1e9
    elif case == "width_mismatch":
        rows = np.concatenate([rows, rows[:, :1]], axis=1)
        rows[0, 4] = 1e12
    return rows


@pytest.mark.parametrize("case", GUARD_CASES)
@pytest.mark.parametrize("policy", ["impute", "reject"])
@pytest.mark.parametrize("with_profile", [True, False])
def test_input_guard_equal(case, policy, with_profile):
    _, _, x = _monitor_pair(64, 1)
    jp = JQ.DataProfile.from_matrix(x, NAMES) if with_profile else None
    pp = PQ.DataProfile.from_matrix(x, NAMES) if with_profile else None
    rows = _guard_input(case, x)
    jg, pg = JQ.InputGuard(jp, policy=policy), PQ.InputGuard(pp, policy=policy)
    (ja, jn, jr), (pa, pn, pr) = jg.inspect(rows), pg.inspect(rows)
    assert (jn, jr) == (pn, pr)
    assert ja.shape == pa.shape and np.array_equal(ja, pa, equal_nan=True)
    with pytest.raises(ValueError, match="policy"):
        PQ.InputGuard(pp, policy="drop")


def test_input_guard_constant_training_column_tolerates_epsilon():
    x = np.column_stack([np.full(200, 7.0), np.linspace(0, 1, 200)])
    jg = JQ.InputGuard(JQ.DataProfile.from_matrix(x, ["c", "v"]))
    pg = PQ.InputGuard(PQ.DataProfile.from_matrix(x, ["c", "v"]))
    rows = np.array([[7.0 + 1e-9, 0.5], [7.0 * 3, 0.5], [7.0 * 1.5, 0.5]])
    assert jg.inspect(rows)[1:] == pg.inspect(rows)[1:] == (1, ["out_of_range:c"])


# ---------------------------------------------------------------- salvage
SCHEMA_LINE = ("hospital_id,event_time,admission_count,current_occupancy,emergency_visits,"
               "seasonality_index,length_of_stay")
GOOD = "H1,2025-03-31 10:00:00,5,100,3,1.0,4.5"
EDGE_TEXTS = {
    "clean": [SCHEMA_LINE, GOOD, "H2,2025-03-31 10:01:00,6,101,4,1.1,5.5"],
    "bad_quotes": [SCHEMA_LINE, GOOD, '"H2,2025-03-31 10:01:00,6,101,4,1.1,5.5',
                   'H"3,2025-03-31 10:02:00,"7",102,5,1.2,6.5'],
    "short_and_long_rows": [SCHEMA_LINE, GOOD, "H2,2025-03-31 10:01:00,6,101",
                            GOOD + ",extra", "H3"],
    "garbage_numerics": [SCHEMA_LINE, "H1,2025-03-31 10:00:00,five,100,3,1.0,4.5",
                         "H1,2025-03-31 10:00:00,1_000,0x10,3,1.0,4.5",
                         "H1,2025-03-31 10:00:00,5,100,3,1.0e,4.5", GOOD],
    "garbage_timestamps": [SCHEMA_LINE, "H1,yesterday,5,100,3,1.0,4.5",
                           "H1,2025-13-31 10:00:00,5,100,3,1.0,4.5", GOOD],
    "empty_fields": [SCHEMA_LINE, "H1,,5,,3,1.0,", ",2025-03-31 10:00:00,,,,,", GOOD],
    "blank_lines": ["", SCHEMA_LINE, "", GOOD, "   ", "H2,bad,6,101,4,1.1,5.5", ""],
    "header_only": [SCHEMA_LINE],
    "empty": [],
    "drifted_header": ["event_time,Hospital-ID,admits,current_occupancy,emergency_visits,los,ward",
                       "2025-03-31 10:00:00,H1,5,100,3,4.5,W1",
                       "2025-03-31 10:01:00,H2,x,100,3,4.5,W2"],
    "whitespace": [SCHEMA_LINE, " H1 , 2025-03-31 10:00:00 , 5 ,100, 3,1.0 , 4.5 "],
}


def _same_salvage(js, ps) -> None:
    _same_table(js.table, ps.table)
    assert [r.to_dict() for r in js.rejects] == [r.to_dict() for r in ps.rejects]
    assert [e.to_dict() for e in js.drift_events] == [e.to_dict() for e in ps.drift_events]
    assert js.n_input_rows == ps.n_input_rows


@pytest.mark.parametrize("case", sorted(EDGE_TEXTS))
@pytest.mark.parametrize("header", [True, False])
def test_salvage_parser_equal_on_edge_inputs(case, header, tmp_path):
    lines = EDGE_TEXTS[case] if header else EDGE_TEXTS[case][1:]
    path = tmp_path / f"{case}.csv"
    path.write_text("\n".join(lines) + ("\n" if lines else ""))
    js = JCSV.read_csv_salvage(str(path), JS.hospital_event_schema(), header, ALIASES)
    ps = PCSV.read_csv_salvage(str(path), PS.hospital_event_schema(), header, ALIASES)
    _same_salvage(js, ps)
    for raw, dtype in (("5", PS.INT), ("x", PS.FLOAT), ("2025-03-31 10:00:00", PS.TIMESTAMP),
                       ("bad", PS.TIMESTAMP), ("", PS.STRING)):
        assert PCSV.parses_as(raw, dtype) == JCSV.parses_as(raw, dtype)


def test_salvage_header_that_is_not_utf8(tmp_path):
    path = tmp_path / "latin1.csv"
    path.write_bytes(SCHEMA_LINE.replace("hospital_id", "hospital_\xefd").encode("latin-1")
                     + b"\n" + GOOD.encode() + b"\n")
    errors = []
    for mod, schema in ((JCSV, JS.hospital_event_schema()), (PCSV, PS.hospital_event_schema())):
        with pytest.raises(UnicodeDecodeError) as e:
            mod.read_csv_salvage(str(path), schema)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_salvage_mapping_cache_rebinds_context_and_dir_read(tmp_path):
    d = tmp_path / "drops"
    d.mkdir()
    for i, case in enumerate(("drifted_header", "garbage_numerics", "drifted_header")):
        (d / f"f{i}.csv").write_text("\n".join(EDGE_TEXTS[case]) + "\n")
    _same_salvage(JCSV.read_csv_dir_salvage(str(d), JS.hospital_event_schema(), True, ALIASES),
                  PCSV.read_csv_dir_salvage(str(d), PS.hospital_event_schema(), True, ALIASES))
    jc, pc = {}, {}
    for f in ("f0.csv", "f2.csv"):
        text = (d / f).read_text()
        _same_salvage(
            JCSV.salvage_from_text(text, JS.hospital_event_schema(), True, ALIASES, f, jc),
            PCSV.salvage_from_text(text, PS.hospital_event_schema(), True, ALIASES, f, pc))
    assert len(pc) == len(jc) == 1
    empty = tmp_path / "none"
    empty.mkdir()
    assert len(PCSV.read_csv_dir_salvage(str(empty), PS.hospital_event_schema()).table) == 0

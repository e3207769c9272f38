"""The port's ``DataFirewall`` and the stream's row quarantine against the
JAX package's, on planted CSV drops, on the CPU.

Each drop goes through both packages' firewalls: the accepted ``Table``,
the reject records, the schema-drift events, the histogram and the
snapshot are ``==`` (host numpy and Python in both; the fast path runs the
same native C scan).  A ``StreamExecution`` with a firewall over the same
drops commits the same table (``ingest_time`` left out: each package's
wall clock) and writes the same row-quarantine records (``quarantined_at``
left out), also after a kill and a resume.
"""

import json

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu.streaming as JS
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.utils import faults as JF
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.streaming as PS
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.io.csv import CSV_TEXT_SITE
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import faults as PF
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils.retry import (
    RetryPolicy,
)

torch.set_num_threads(1)

FAST = RetryPolicy(max_attempts=3, base_delay_s=0.001, max_delay_s=0.01)
PACKAGES = {"jax": (J, JS, JF), "port": (P, PS, PF)}
HEADER = ("hospital_id,event_time,admission_count,current_occupancy,emergency_visits,"
          "seasonality_index,length_of_stay")
ALIASES = {"admits": "admission_count", "los": "length_of_stay"}
FEATURES = ("admission_count", "current_occupancy", "emergency_visits", "seasonality_index")


@pytest.fixture(autouse=True)
def _flight_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("CMLHN_FLIGHT_DIR", str(tmp_path / "flight"))


def _rows(n: int, seed: int, minute: int = 0) -> list[str]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        s = minute * 60 + i
        out.append(f"H{rng.integers(0, 4)},2025-03-31 {10 + s // 3600:02d}:{s // 60 % 60:02d}:"
                   f"{s % 60:02d},{rng.integers(0, 50)},{rng.integers(0, 900)},"
                   f"{rng.integers(0, 40)},{rng.uniform(0.5, 1.5)!r},{rng.uniform(1, 12)!r}")
    return out


def _drop(kind: str, seed: int, minute: int = 0) -> str:
    rows = _rows(40, seed, minute)
    if kind == "clean":
        pass
    elif kind == "garbage_numeric":          # the strict fast path, then the rescan
        rows[3] = rows[3].replace(",", ",x7,", 2).replace(",x7,", ",", 1)
        parts = rows[9].split(",")
        parts[5] = "1.0e"
        rows[9] = ",".join(parts)
    elif kind == "ragged":                   # the fast path pads it: a field_count reject
        rows[4] = ",".join(rows[4].split(",")[:5])
    elif kind == "constraints":              # range, non-finite, null, NaN (passes)
        p = [r.split(",") for r in rows]
        p[1][2], p[2][3], p[5][5], p[6][6], p[8][0], p[11][4] = (
            "20000", "-3", "inf", "400", "", "")
        rows = [",".join(x) for x in p]
    elif kind == "renamed_header":           # salvage: aliases and a reorder
        hdr = "event_time,hospital_id,admits,current_occupancy,emergency_visits,los,ward"
        p = [r.split(",") for r in rows]
        body = [f"{x[1]},{x[0]},{x[2]},{x[3]},{x[4]},{x[6]},W{i}" for i, x in enumerate(p)]
        body[7] = body[7].replace(",W7", ",W7,extra")
        return "\n".join([hdr] + body) + "\n"
    elif kind == "blank_lines":
        rows.insert(5, "")
        rows.insert(20, "   ")
        rows[30] = rows[30].replace("2025-03-31", "2025-99-31")
    else:
        raise ValueError(kind)
    return "\n".join([HEADER] + rows) + "\n"


KINDS = ("clean", "garbage_numeric", "ragged", "constraints", "renamed_header", "blank_lines")


def _profile(pkg):
    rng = np.random.default_rng(9)
    x = np.column_stack([rng.integers(0, 50, 5000), rng.integers(0, 900, 5000),
                         rng.integers(0, 40, 5000), rng.uniform(0.5, 1.5, 5000)])
    return pkg.DataProfile.from_matrix(x.astype(np.float64), FEATURES)


def _firewall(pkg, monitor: bool, rescan: bool = True):
    top = PACKAGES[pkg][0]
    mon = top.DriftMonitor(_profile(top), window_rows=32, trip_after=2) if monitor else None
    return top.DataFirewall(top.hospital_event_schema(), top.hospital_constraints(),
                            aliases=ALIASES, monitor=mon, rescan_nulls=rescan)


def _same_table(a, b, skip=("ingest_time",)) -> None:
    names = [n for n in a.schema.names if n not in skip]
    assert names == [n for n in b.schema.names if n not in skip] and len(a) == len(b)
    for n in names:
        x, y = a.columns[n], b.columns[n]
        assert x.dtype == y.dtype, n
        if x.dtype.kind == "M":
            assert np.array_equal(x.view("i8"), y.view("i8")), n
        elif x.dtype.kind == "f":
            assert np.array_equal(x, y, equal_nan=True), n
        else:
            assert list(x) == list(y), n


def _same_result(a, b) -> None:
    _same_table(a.table, b.table)
    assert a.rejects == b.rejects and a.histogram == b.histogram
    assert [e.to_dict() for e in a.drift_events] == [e.to_dict() for e in b.drift_events]
    assert (a.n_input, a.n_rejected) == (b.n_input, b.n_rejected)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rescan", [True, False])
def test_firewall_ingest_file_equal(tmp_path, kind, rescan):
    path = tmp_path / f"{kind}.csv"
    path.write_text(_drop(kind, 1))
    fw = {pkg: _firewall(pkg, monitor=True, rescan=rescan) for pkg in PACKAGES}
    got = {pkg: f.ingest_file(str(path)) for pkg, f in fw.items()}
    _same_result(got["port"], got["jax"])
    snaps = {pkg: f.snapshot() for pkg, f in fw.items()}
    assert snaps["port"] == snaps["jax"]
    assert set(fw["port"].stage_seconds) == {"parse", "validate"}
    if kind == "constraints":
        assert got["port"].histogram == {
            "range:admission_count": 1, "range:current_occupancy": 1, "range:length_of_stay": 1,
            "range:seasonality_index": 1, "non_finite:seasonality_index": 1,
            "null:hospital_id": 1}


def test_firewall_over_many_drops_and_a_drift_monitor(tmp_path):
    fw = {pkg: _firewall(pkg, monitor=True) for pkg in PACKAGES}
    for i, kind in enumerate(KINDS * 3):
        path = tmp_path / f"{i:02d}.csv"
        path.write_text(_drop(kind, i, minute=i))
        _same_result(fw["port"].ingest_file(str(path)), fw["jax"].ingest_file(str(path)))
    assert fw["port"].snapshot() == fw["jax"].snapshot()
    assert fw["port"].snapshot()["drift"]["windows"] > 0
    # the header-mapping cache holds one entry per drifted layout
    assert len(fw["port"]._mapping_cache) == len(fw["jax"]._mapping_cache) == 1


@pytest.mark.parametrize("rule", ["mangle", "shuffle", "unit_scale", "nan_burst"])
def test_firewall_under_data_fault_rules_equal(tmp_path, rule):
    path = tmp_path / "d.csv"
    path.write_text(_drop("clean", 4))
    got = {}
    for pkg, (_, _, faults) in PACKAGES.items():
        plan = faults.FaultPlan(seed=11)
        if rule == "mangle":
            plan.mangle_fields(CSV_TEXT_SITE, rate=0.05)
        elif rule == "shuffle":
            plan.shuffle_columns(CSV_TEXT_SITE)
        elif rule == "unit_scale":
            plan.unit_scale(CSV_TEXT_SITE, "length_of_stay", factor=100.0)
        else:
            plan.nan_burst(CSV_TEXT_SITE, "admission_count", length=5)
        with faults.active(plan):
            got[pkg] = _firewall(pkg, monitor=False).ingest_file(str(path))
    _same_result(got["port"], got["jax"])


def test_firewall_ingest_table_equal():
    rng = np.random.default_rng(2)
    cols = {"hospital_id": np.array(["H1"] * 30, dtype=object),
            "event_time": np.datetime64("2025-03-31T10:00:00", "ns")
            + np.arange(30).astype("timedelta64[m]").astype("timedelta64[ns]"),
            "admission_count": rng.integers(0, 50, 30).astype(float),
            "current_occupancy": rng.integers(0, 900, 30).astype(float),
            "emergency_visits": rng.integers(0, 40, 30).astype(float),
            "seasonality_index": rng.uniform(0.5, 1.5, 30),
            "length_of_stay": rng.uniform(1, 12, 30)}
    cols["length_of_stay"][4] = 999.0
    got = {pkg: _firewall(pkg, monitor=False).ingest_table(
        top.Table.from_dict(cols, top.hospital_event_schema()), "arrow-handoff")
        for pkg, (top, _, _) in PACKAGES.items()}
    _same_result(got["port"], got["jax"])
    assert got["port"].rejects[0]["context"] == "arrow-handoff"


# ------------------------------------------------------------------ stream
def _stream(pkg, root, incoming, **kw):
    top, st, _ = PACKAGES[pkg]
    if pkg == "port":
        kw["device"] = "cpu"
    return st.StreamExecution(
        source=st.FileStreamSource(str(incoming), top.hospital_event_schema(), retry=FAST,
                                   max_files_per_batch=2),
        sink=st.UnboundedTable(str(root / "table"), top.hospital_event_schema()),
        checkpoint=st.StreamCheckpoint(str(root / "ckpt")),
        firewall=_firewall(pkg, monitor=True),
        replay_backoff=FAST, **kw)


def _drain(exec_) -> list:
    infos = []
    while (info := exec_.run_once()) is not None:
        infos.append(info)
    return infos


def _info(b):
    return (b.batch_id, b.num_input_rows, b.num_late_rows, b.num_appended_rows,
            [f.rsplit("/", 1)[-1] for f in b.files], b.status, b.num_rejected_rows,
            b.num_drift_events)


def _quarantine(ckpt) -> list:
    return [{k: v for k, v in e.items() if k != "quarantined_at"}
            for e in ckpt.quarantined_rows()]


def _write_drops(incoming, n=8) -> None:
    incoming.mkdir()
    for i in range(n):
        (incoming / f"drop-{i:02d}.csv").write_text(_drop(KINDS[i % len(KINDS)], i, minute=i))


def test_firewalled_stream_commits_the_same_table_and_quarantine(tmp_path):
    incoming = tmp_path / "in"
    _write_drops(incoming)
    runs = {}
    for pkg in PACKAGES:
        ex = _stream(pkg, tmp_path / pkg, incoming)
        runs[pkg] = (ex, _drain(ex))
    (pe, pinfo), (je, jinfo) = runs["port"], runs["jax"]
    assert [_info(b) for b in pinfo] == [_info(b) for b in jinfo]
    _same_table(pe.sink.read(), je.sink.read())
    assert _quarantine(pe.checkpoint) == _quarantine(je.checkpoint)
    assert pe.checkpoint.row_reason_histogram() == je.checkpoint.row_reason_histogram()
    assert pe.checkpoint.quarantined_row_count() == je.checkpoint.quarantined_row_count() > 0
    for name in ("stream.rows_rejected", "stream.drift_events", "stream.batches"):
        assert pe.metrics.counters[name] == je.metrics.counters[name], name
    assert pe.metrics.gauges["stream.drift_psi"] == je.metrics.gauges["stream.drift_psi"]
    rows = [json.loads(line) for line in
            (tmp_path / "port" / "ckpt" / "offsets.log").read_text().splitlines()]
    assert [r["files"] for r in rows] == [json.loads(line)["files"] for line in
                                         (tmp_path / "jax" / "ckpt" / "offsets.log")
                                         .read_text().splitlines()]
    # a server folding the stream's registry reports the same rows
    srv = P.serve.InferenceServer(device="cpu", ingest_metrics=pe.metrics)
    h = srv.health()
    assert h["quarantined_rows"] == pe.checkpoint.quarantined_row_count()
    assert h["drift_events"] == pe.metrics.counters["stream.drift_events"]


@pytest.mark.parametrize("site", ["stream.after_read", "stream.after_sink",
                                  "stream.after_commit"])
def test_firewalled_stream_killed_and_resumed_matches_an_uninterrupted_run(tmp_path, site):
    incoming = tmp_path / "in"
    _write_drops(incoming, 6)
    want = _stream("jax", tmp_path / "jax", incoming)
    _drain(want)
    plan = PF.FaultPlan().crash(site, after=1)
    with PF.active(plan):
        with pytest.raises(PF.InjectedCrash):
            _drain(_stream("port", tmp_path / "port", incoming))
    assert plan.fired(site) == 1
    resumed = _stream("port", tmp_path / "port", incoming)
    _drain(resumed)
    _same_table(resumed.sink.read(), want.sink.read())
    assert _quarantine(resumed.checkpoint) == _quarantine(want.checkpoint)
    # the resumed process counts each batch's rejects once
    assert resumed.metrics.counters["stream.rows_rejected"] + sum(
        e["n_rejected"] for e in _quarantine(resumed.checkpoint)
        if e["batch_id"] < resumed.history[0].batch_id) == \
        want.metrics.counters["stream.rows_rejected"]


def test_source_without_a_firewall_reads_strictly(tmp_path):
    incoming = tmp_path / "in"
    _write_drops(incoming, 2)
    src = P.FileStreamSource(str(incoming), P.hospital_event_schema())
    files = src.poll()
    table, rejects, events = src.read_files_audited(files)
    _same_table(table, src.read_files(files))
    assert (rejects, events) == ([], [])
    assert src.read_files_audited([])[1:] == ([], [])

"""Streaming ingest: the port's watermark, file source, checkpoint,
micro-batch loop and unbounded table against the JAX package's, on the
same CSV drops, on the CPU.

Everything here is host work on the same parsed values, so every
comparison is exact: kept rows, late counts, watermark state strings,
``BatchInfo`` sequences, the offsets and commits logs line for line, and
the snapshots on every column.  The one column left out of a comparison
is ``ingest_time``, the wall clock at which each package read the batch.

The kill and torn-write cases mirror ``tests/test_chaos.py``'s stream
cases: a kill at each lifecycle boundary, and a WAL append torn at bytes
0, 1, mid-entry and last-1 in each log, resume with every row exactly
once.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu.streaming as JS
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.streaming as PS
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.obs.registry import (
    global_registry,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.streaming.wal import (
    append_line,
    read_lines,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import faults
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils.retry import (
    RetryPolicy,
)

# the suite runs several worker processes on a few cores: one intra-op
# thread per worker keeps torch from oversubscribing them
torch.set_num_threads(1)

#: near-instant backoffs so the cases exercise the ladder, not the clock
FAST = RetryPolicy(max_attempts=3, base_delay_s=0.001, max_delay_s=0.01)
STREAM_SITES = [
    "stream.after_offsets",
    "stream.after_read",
    "stream.after_foreach",
    "stream.after_sink",
    "stream.after_commit",
]
PACKAGES = {"jax": (J, JS), "port": (P, PS)}


@pytest.fixture(autouse=True)
def _flight_dumps_under_tmp(tmp_path, monkeypatch):
    """Injected crashes write postmortems; keep them in the test's tree."""
    monkeypatch.setenv("CMLHN_FLIGHT_DIR", str(tmp_path / "flight"))


def _event_csv(path, start_minute, n, hospital="H01", seed=0):
    """``n`` events a second apart from 22:00 + ``start_minute``, written
    by the port's ``write_csv`` (floats through ``str()``)."""
    rng = np.random.default_rng(seed)
    base = np.datetime64("2025-03-31T22:00:00") + np.timedelta64(start_minute, "m")
    t = P.Table.from_dict(
        {
            "hospital_id": np.array([hospital] * n, dtype=object),
            "event_time": base + np.arange(n).astype("timedelta64[s]"),
            "admission_count": rng.integers(0, 50, n),
            "current_occupancy": rng.integers(20, 400, n),
            "emergency_visits": rng.integers(0, 30, n),
            "seasonality_index": rng.uniform(0.5, 1.5, n),
            "length_of_stay": rng.normal(4.0, 1.0, n),
        },
        P.hospital_event_schema(),
    )
    P.write_csv(t, str(path))
    return t


def _stream(pkg, root, incoming, foreach=None, watermark=10.0, **kw):
    """A fresh stream of ``pkg`` over ``root``'s table and checkpoint —
    calling it again after a crash IS the process restart."""
    top, st = PACKAGES[pkg]
    src = st.FileStreamSource(str(incoming), top.hospital_event_schema(), retry=FAST,
                              max_files_per_batch=kw.pop("max_files_per_batch", 0))
    if pkg == "port":
        kw["device"] = "cpu"
    return st.StreamExecution(
        source=src,
        sink=st.UnboundedTable(str(root / "table"), top.hospital_event_schema()),
        checkpoint=st.StreamCheckpoint(str(root / "ckpt")),
        watermark=None if watermark is None else st.WatermarkTracker("event_time", watermark),
        foreach_batch=foreach,
        replay_backoff=FAST,
        **kw,
    )


def _drain(pkg, root, incoming, **kw):
    exec_ = _stream(pkg, root, incoming, **kw)
    infos = []
    while (info := exec_.run_once()) is not None:
        infos.append(info)
    return exec_, infos


def _assert_tables_equal(got, want, skip=("ingest_time",)):
    names = [n for n in want.schema.names if n not in skip]
    assert [n for n in got.schema.names if n not in skip] == names
    assert got.num_rows == want.num_rows
    for n in names:
        assert got[n].dtype == want[n].dtype, n
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def _batch_tuple(b):
    return (b.batch_id, b.num_input_rows, b.num_late_rows, b.num_appended_rows,
            list(b.files), b.status)


# ============================================================== watermark
def test_watermark_tracker_equals_jax():
    """The same batches through both trackers: the same rows kept, the
    same late counts, the same ``state()`` strings, and a restore of
    either package's state continues identically."""
    rng = np.random.default_rng(3)
    base = np.datetime64("2025-03-31T22:00:00", "ns")
    jw, pw = J.streaming.WatermarkTracker("event_time", 10.0), PS.WatermarkTracker("event_time", 10.0)
    assert pw.state() == jw.state() == {"max_event_time": None}
    for step in range(6):
        secs = rng.integers(-1800, 3600 + 600 * step, 40)
        times = (base + secs.astype("timedelta64[s]")).astype("datetime64[ns]")
        times[rng.integers(0, 40, 3)] = np.datetime64("NaT")
        data = {"event_time": times, "v": np.arange(40.0)}
        jk, jd = jw.filter_late(J.Table.from_dict(data))
        pk, pd = pw.filter_late(P.Table.from_dict(data))
        assert pd == jd
        np.testing.assert_array_equal(pk["v"], jk["v"])
        assert pw.state() == jw.state()
        assert pw.watermark == jw.watermark
    again = PS.WatermarkTracker("event_time", 10.0)
    again.restore(jw.state())
    assert again.state() == jw.state() and again.watermark == jw.watermark


# ================================================================ stream
def test_stream_execution_equals_jax(tmp_path):
    """Both streams over the same drops, one file a batch, so the
    watermark from earlier batches drops late rows: the same batch
    sequence, the same offsets and commits lines, the same snapshot."""
    incoming = tmp_path / "in"
    incoming.mkdir()
    for i, (start, n) in enumerate([(30, 50), (5, 40), (25, 30), (50, 20), (0, 10)]):
        _event_csv(incoming / f"h{i}.csv", start, n, hospital=f"H{i:02d}", seed=i)
        os.utime(incoming / f"h{i}.csv", ns=(10**18 + i, 10**18 + i))
    seen = {"jax": [], "port": []}
    runs = {}
    for pkg in PACKAGES:
        runs[pkg] = _drain(pkg, tmp_path / pkg, incoming, max_files_per_batch=1,
                           foreach=lambda t, b, pkg=pkg: seen[pkg].append((b, t.num_rows)))
    (je, jinfos), (pe, pinfos) = runs["jax"], runs["port"]
    assert [_batch_tuple(b) for b in pinfos] == [_batch_tuple(b) for b in jinfos]
    assert len(pinfos) == 5 and sum(b.num_late_rows for b in pinfos) > 0
    assert seen["port"] == seen["jax"]
    for log in ("offsets.log", "commits.log"):
        assert (read_lines(str(tmp_path / "port" / "ckpt" / log))
                == read_lines(str(tmp_path / "jax" / "ckpt" / log))), log
    assert (read_lines(str(tmp_path / "port/table/_commits.log"))
            == read_lines(str(tmp_path / "jax/table/_commits.log")))
    _assert_tables_equal(pe.sink.read(), je.sink.read())
    assert pe.sink.num_rows() == je.sink.num_rows() and pe.sink.max_batch_id() == 4
    assert pe.watermark.state() == je.watermark.state()


@pytest.mark.parametrize("site", STREAM_SITES + ["sink.write_part", "source.read_file"])
def test_stream_killed_at_each_site_resumes_exactly_once(tmp_path, site):
    """A kill at each lifecycle boundary mid-batch; a restarted stream
    delivers every row exactly once — replaying the in-flight batch when
    it died before its commit line, skipping it when it died after."""
    incoming = tmp_path / "in"
    incoming.mkdir()
    exec_ = _stream("port", tmp_path, incoming, watermark=None)
    _event_csv(incoming / "a.csv", 0, 30)
    assert exec_.run_once().num_appended_rows == 30
    _event_csv(incoming / "b.csv", 1, 20, seed=1)
    plan = faults.FaultPlan().crash(site)
    with faults.active(plan):
        with pytest.raises(faults.InjectedCrash):
            exec_.run_once()
    assert plan.fired(site) == 1

    exec2, infos = _drain("port", tmp_path, incoming, watermark=None)
    snap = exec2.sink.read()
    assert snap.num_rows == 50
    assert exec2.checkpoint.quarantine_count() == 0
    assert exec2.sink.max_batch_id() == 1
    assert exec2.run_once() is None
    # every row once: the snapshot is the two drops in order
    want = P.Table.concat([P.read_csv(str(incoming / f), P.hospital_event_schema())
                           for f in ("a.csv", "b.csv")])
    _assert_tables_equal(snap.select(want.schema.names), want.na_drop())


@pytest.mark.parametrize("log_name", ["offsets.log", "commits.log"])
@pytest.mark.parametrize("cut", [0, 1, 15, -1], ids=["b0", "b1", "mid", "last-1"])
def test_stream_survives_torn_wal_write(tmp_path, log_name, cut):
    """A WAL append torn at an exact byte offset in each log: recovery
    neither loses nor duplicates rows, and the log stays appendable."""
    incoming = tmp_path / "in"
    incoming.mkdir()
    exec_ = _stream("port", tmp_path, incoming, watermark=None)
    _event_csv(incoming / "a.csv", 0, 30)
    exec_.run_once()
    _event_csv(incoming / "b.csv", 1, 20, seed=1)
    plan = faults.FaultPlan().tear(
        "wal.append", at_byte=cut,
        when=lambda ctx: ctx.get("path", "").endswith(log_name),
    )
    with faults.active(plan):
        with pytest.raises(faults.InjectedCrash):
            exec_.run_once()
    assert plan.fired("wal.append") == 1

    exec2, _ = _drain("port", tmp_path, incoming, watermark=None)
    assert exec2.sink.read().num_rows == 50
    assert exec2.run_once() is None
    _event_csv(incoming / "c.csv", 2, 10, seed=2)
    exec3, infos = _drain("port", tmp_path, incoming, watermark=None)
    assert exec3.sink.read().num_rows == 60
    assert infos[-1].num_appended_rows == 10


def test_poison_batch_quarantined_with_the_jax_record(tmp_path):
    """A batch that fails every attempt is quarantined after
    ``max_batch_replays`` tries and committed as skipped; the evidence
    record has the JAX package's keys, and the JAX checkpoint reads it."""
    incoming = tmp_path / "in"
    incoming.mkdir()
    _event_csv(incoming / "a.csv", 0, 10)
    exec_ = _stream("port", tmp_path, incoming, watermark=None)
    plan = faults.FaultPlan().fail("stream.after_read", times=None)
    with faults.active(plan):
        info = exec_.run_once()
    assert info.status == PS.BATCH_QUARANTINED and plan.fired("stream.after_read") == 3
    assert exec_.metrics.counters["stream.quarantined"] == 1
    (rec,) = exec_.checkpoint.quarantined()
    jrec = JS.StreamCheckpoint(str(tmp_path / "ckpt")).quarantined()
    assert jrec == [rec]
    assert {"batch_id", "files", "attempts", "error", "reason", "sink_rows_visible",
            "quarantined_at"} == set(rec)
    assert rec["reason"] == "poison" and rec["attempts"] == 3
    assert exec_.run_once() is None and exec_.sink.read().num_rows == 0
    state = JS.StreamCheckpoint(str(tmp_path / "ckpt")).recover()
    assert state["pending"] is None and state["next_batch_id"] == 1


def test_disk_budget_refuses_appends(tmp_path):
    schema = P.Schema([P.Field("a", "float")])
    t = P.Table.from_dict({"a": np.arange(4.0)}, schema)
    ut = PS.UnboundedTable(str(tmp_path / "ut"), schema, disk_budget_bytes=1)
    ut.append_batch(t, 0)
    with pytest.raises(PS.DiskBudgetExceeded, match="disk:budget"):
        ut.append_batch(t, 1)
    assert ut.num_rows() == 4 and PS.DiskBudgetExceeded.reason == "disk:budget"


# ========================================================= cross-package
@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
def test_table_and_checkpoint_resume_across_packages(tmp_path, first, second):
    """A table and a checkpoint written by one package are resumed by the
    other: the processed files, the batch ids and the watermark state
    carry over, and the logs and the snapshot equal those of the JAX
    package resuming its own."""
    incoming = tmp_path / "in"
    incoming.mkdir()
    _event_csv(incoming / "a.csv", 30, 40)
    os.utime(incoming / "a.csv", ns=(10**18, 10**18))
    for root, pkgs in (("mixed", (first, second)), ("ref", ("jax", "jax"))):
        _drain(pkgs[0], tmp_path / root, incoming)
    _event_csv(incoming / "b.csv", 0, 40, seed=1)
    os.utime(incoming / "b.csv", ns=(10**18 + 1, 10**18 + 1))
    mixed, infos = _drain(second, tmp_path / "mixed", incoming)
    ref, ref_infos = _drain("jax", tmp_path / "ref", incoming)
    assert [_batch_tuple(b) for b in infos] == [_batch_tuple(b) for b in ref_infos]
    assert [(b.batch_id, b.num_input_rows) for b in infos] == [(1, 40)]
    _assert_tables_equal(mixed.sink.read(), ref.sink.read())
    for log in ("offsets.log", "commits.log"):
        assert (read_lines(str(tmp_path / "mixed/ckpt" / log))
                == read_lines(str(tmp_path / "ref/ckpt" / log))), log
    assert mixed.watermark.state() == ref.watermark.state()


def test_restart_restores_the_watermark_of_the_last_intent(tmp_path):
    """Pins a fault of the reference that the port keeps: ``recover()``
    restores the watermark state recorded with the last batch's offsets
    intent, which is the state BEFORE that batch advanced it.  Within one
    process a drop 50 minutes behind batch 0 is late; after a restart
    between the two batches, both packages keep it (Spark restores the
    advanced watermark from its commit log)."""
    for pkg in PACKAGES:
        incoming = tmp_path / pkg / "in"
        incoming.mkdir(parents=True)
        _event_csv(incoming / "a.csv", 60, 10)
        in_process = _stream(pkg, tmp_path / pkg / "one", incoming)
        in_process.run_once()
        _drain(pkg, tmp_path / pkg / "two", incoming)      # batch 0, then exit
        _event_csv(incoming / "b.csv", 0, 5, seed=1)
        assert in_process.run_once().num_late_rows == 5, pkg
        restarted = _stream(pkg, tmp_path / pkg / "two", incoming)
        assert restarted.watermark.state() == {"max_event_time": None}, pkg
        assert restarted.run_once().num_late_rows == 0, pkg


def test_port_reads_a_jax_snapshot_with_ingest_time(tmp_path):
    """The port's reader over a JAX-written table: every column, the
    JAX package's ``ingest_time`` included, equal to the JAX reader's."""
    incoming = tmp_path / "in"
    incoming.mkdir()
    _event_csv(incoming / "a.csv", 0, 25)
    _event_csv(incoming / "b.csv", 5, 25, seed=1)
    je, _ = _drain("jax", tmp_path, incoming, watermark=None, max_files_per_batch=1)
    got = PS.UnboundedTable(str(tmp_path / "table"), P.hospital_event_schema()).read()
    _assert_tables_equal(got, je.sink.read(), skip=())
    assert got.schema.field("ingest_time").dtype == "timestamp"


def test_seal_entries_raise_and_audit_entries_are_skipped(tmp_path):
    """Audit entries (retire, scrub) change no content and are skipped; a
    seal entry moves rows into a segment the port cannot read yet, so
    ``read()`` raises instead of answering without them."""
    schema = P.Schema([P.Field("a", "float")])
    ut = PS.UnboundedTable(str(tmp_path / "ut"), schema)
    ut.append_batch(P.Table.from_dict({"a": np.arange(4.0)}, schema), 0)
    log = str(tmp_path / "ut" / "_commits.log")
    append_line(log, {"retire": {"files": []}})
    append_line(log, {"scrub": {"checked": 1}})
    assert ut.read().num_rows == 4 and ut.num_rows() == 4
    append_line(log, {"seal": {"first": 0, "last": 0, "file": "seg.parquet",
                               "batches": [{"batch_id": 0, "rows": 4}]}})
    with pytest.raises(PS.SealedSegmentsNotPorted, match="slice 6"):
        ut.read()
    assert ut.num_rows() == 4 and ut.max_batch_id() == 0


def test_missing_committed_part_raises(tmp_path):
    """Without sealed segments a committed part has no other copy: a
    missing one is data loss, and ``read()`` says so."""
    schema = P.Schema([P.Field("a", "float")])
    ut = PS.UnboundedTable(str(tmp_path / "ut"), schema)
    ut.append_batch(P.Table.from_dict({"a": np.arange(4.0)}, schema), 0)
    ut.append_batch(P.Table.from_dict({"a": np.zeros(0)}, schema), 1)   # empty: no rows to lose
    os.remove(tmp_path / "ut" / "part-0000000000.parquet")
    with pytest.raises(FileNotFoundError, match="part-0000000000.parquet"):
        PS.UnboundedTable(str(tmp_path / "ut"), schema).read()


def test_reads_without_pyarrow_need_it_only_for_parts(tmp_path, monkeypatch):
    """Without pyarrow an empty table still reads (no part to decode),
    and a read or an append that needs a Parquet part raises an
    ``ImportError`` naming the ``parquet`` extra."""
    schema = P.Schema([P.Field("a", "float")])
    full = PS.UnboundedTable(str(tmp_path / "full"), schema)
    full.append_batch(P.Table.from_dict({"a": np.arange(4.0)}, schema), 0)
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    empty = PS.UnboundedTable(str(tmp_path / "empty"), schema)
    got = empty.read()
    assert len(got) == 0 and got.schema.names == ["a"]
    with pytest.raises(ImportError, match="'parquet' extra"):
        PS.UnboundedTable(str(tmp_path / "full"), schema).read()
    with pytest.raises(ImportError, match="'parquet' extra"):
        empty.append_batch(P.Table.from_dict({"a": np.arange(4.0)}, schema), 0)
    assert empty.max_batch_id() == -1


def test_replayed_batch_replaces_its_part(tmp_path):
    """A batch appended twice (a replay) counts once, the later part wins,
    and the snapshot memo notices the rewritten part."""
    schema = P.Schema([P.Field("a", "float")])
    ut = PS.UnboundedTable(str(tmp_path / "ut"), schema)
    ut.append_batch(P.Table.from_dict({"a": np.arange(4.0)}, schema), 0)
    first = ut.read()
    ut.append_batch(P.Table.from_dict({"a": np.arange(4.0) + 10}, schema), 0)
    again = ut.read()
    assert again is not first and ut.num_rows() == 4
    np.testing.assert_array_equal(again["a"], np.arange(4.0) + 10)
    jt = JS.UnboundedTable(str(tmp_path / "ut"), J.Schema([J.Field("a", "float")])).read()
    np.testing.assert_array_equal(jt["a"], again["a"])


def test_window_rerun_over_unchanged_table_hits_both_caches(tmp_path):
    """Between appends ``read()`` returns the same snapshot object, so the
    compiled window's second run transfers nothing: one snapshot miss and
    device-column misses first, then only hits; an append misses again."""
    incoming = tmp_path / "in"
    incoming.mkdir()
    _event_csv(incoming / "a.csv", 0, 60)
    spark = P.Session(P.PipelineConfig(checkpoint_location=str(tmp_path / "ck")), device="cpu")
    try:
        q = (spark.read_stream.schema(P.hospital_event_schema()).csv(str(incoming))
             .write_stream.option("checkpointLocation", str(tmp_path / "ck"))
             .table("events"))
        q.process_available()
        window = ("SELECT * FROM events WHERE event_time BETWEEN "
                  "'2025-03-31 22:00:00' AND '2025-03-31 22:00:30'")
        g = global_registry()

        def counts():
            return {k: g.counters.get(f"sql.cache.{k}", 0.0)
                    for k in ("snapshot.hit", "snapshot.miss", "device.hit", "device.miss")}

        c0 = counts()
        first = spark.sql(window)
        c1 = counts()
        assert c1["snapshot.miss"] - c0["snapshot.miss"] == 1
        assert c1["device.miss"] - c0["device.miss"] >= 1
        snap = spark.table("events")
        c2 = counts()
        again = spark.sql(window)
        c3 = counts()
        assert spark.table("events") is snap
        assert c3["snapshot.miss"] == c2["snapshot.miss"] and c3["snapshot.hit"] > c2["snapshot.hit"]
        assert c3["device.miss"] == c2["device.miss"] and c3["device.hit"] > c2["device.hit"]
        assert P.core.sql.last_dispatch().route == "compiled"
        assert again.num_rows == first.num_rows == 31
        _event_csv(incoming / "b.csv", 1, 10, seed=1)
        q.process_available()
        assert spark.table("events") is not snap
        assert counts()["snapshot.miss"] == c3["snapshot.miss"] + 1
    finally:
        spark.stop()


def test_checkpoint_recover_reads_the_piggybacked_attempt(tmp_path):
    """``begin_batch`` writes the offsets intent and the first attempt as
    one line, which both packages count as an attempt on restart."""
    ck = PS.StreamCheckpoint(str(tmp_path / "ck"))
    assert ck.begin_batch(0, ["a.csv"], {}) == 1
    assert ck.record_attempt(0) == 2
    assert PS.StreamCheckpoint(str(tmp_path / "ck")).attempts(0) == 2
    assert JS.StreamCheckpoint(str(tmp_path / "ck")).attempts(0) == 2
    rec = PS.StreamCheckpoint(str(tmp_path / "ck")).recover()
    assert rec == JS.StreamCheckpoint(str(tmp_path / "ck")).recover()
    assert rec["pending"]["files"] == ["a.csv"] and rec["next_batch_id"] == 1
    with open(tmp_path / "ck" / "offsets.log") as f:
        assert json.loads(f.readline()) == {
            "batch_id": 0, "files": ["a.csv"], "watermark": {}, "attempt": True}

"""The port's pipelined stream (``streaming/pipeline.py``), the stream's
``prefetched`` / ``add_ingest_time`` plumbing and ``utils/profiling.py``,
on the CPU.

The parity gate is the pipelined stream's promise: overlapping parse and
firewall on a worker thread with the model update must not change a
single observable.  Each case holds the port's pipelined stream against
the port's serial stream on the same files, exactly: batches, sink rows,
quarantine evidence, WAL lines and StreamingKMeans state (``==``: the
same update sequence on the same rows); one case holds it against the JAX
package's pipelined stream, exactly too (host work on the same parsed
values, but the wall-clock ``ingest_time`` column).  The one comparison
that is not exact is the backlog drain through ``update_many`` against
per-batch updates: centers at rtol 1e-5 / atol 1e-6, the reference's own
bound for the same claim (``tests/test_stream_pipeline.py``), though the
port's drain applies the identical per-batch sequence and meets it
exactly.

The cases of ``tests/test_stream_pipeline.py`` that apply to one device
are here; its donation, recompile and mesh cases test XLA buffers and
meshes that eager torch on one device does not have.
"""

import os
import time
import warnings

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu.streaming as JS
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.data import batch_rows
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.quality import (
    DataFirewall,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.streaming import (
    FileStreamSource,
    ModelUpdateConsumer,
    PipelinedStreamExecution,
    Prefetched,
    StreamCheckpoint,
    StreamExecution,
    UnboundedTable,
    WatermarkTracker,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.streaming.pipeline import (
    make_sql_feature_stage,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.streaming.wal import (
    read_lines,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import (
    faults,
    profiling,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils.retry import (
    RetryPolicy,
)

torch.set_num_threads(1)

FEATURES = list(P.FEATURE_COLS)
FAST = RetryPolicy(max_attempts=3, base_delay_s=0.001, max_delay_s=0.01)


@pytest.fixture(autouse=True)
def _flight_dumps_under_tmp(tmp_path, monkeypatch):
    """Injected crashes write postmortems; keep them in the test's tree."""
    monkeypatch.setenv("CMLHN_FLIGHT_DIR", str(tmp_path / "flight"))


def _event_csv(path, start_minute, n, rng, dirty_lines=()):
    base = np.datetime64("2025-03-31T22:00:00") + np.timedelta64(int(start_minute), "m")
    t = P.Table.from_dict(
        {
            "hospital_id": np.array(["H01"] * n, dtype=object),
            "event_time": base + np.arange(n).astype("timedelta64[s]"),
            "admission_count": rng.integers(0, 50, n),
            "current_occupancy": rng.integers(20, 200, n),
            "emergency_visits": rng.integers(0, 30, n),
            "seasonality_index": rng.uniform(0.5, 1.5, n),
            "length_of_stay": rng.uniform(1.0, 9.0, n),
        },
        P.hospital_event_schema(),
    )
    P.write_csv(t, path)
    if dirty_lines:
        with open(path) as f:
            lines = f.read().rstrip("\n").split("\n")
        for idx, garbage in dirty_lines:
            lines[idx] = garbage
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")


def _drop_fleet(incoming, n_files=5, rows=200, dirty=False):
    rng = np.random.default_rng(7)
    for i in range(n_files):
        dirty_lines = []
        if dirty and i % 2 == 1:
            # line 3 gets a garbage numeric, line 5 a ragged row
            dirty_lines = [
                (3, "H01,2025-03-31 22:00:00,banana,100,5,1.0,4.0"),
                (5, "H01,2025-03-31 22:00:01,7"),
            ]
        path = str(incoming / f"{i:02d}.csv")
        _event_csv(path, i, rows, rng, dirty_lines=dirty_lines)
        os.utime(path, ns=(10**18 + i, 10**18 + i))


def _build(tmp_path, pipelined, tag, foreach=None, firewall=False, watermark=None,
           pkg=None, **kw):
    top, st = (J, JS) if pkg == "jax" else (P, P.streaming)
    src = st.FileStreamSource(str(tmp_path / "incoming"), top.hospital_event_schema(),
                              max_files_per_batch=1, retry=FAST)
    sink = st.UnboundedTable(str(tmp_path / f"table_{tag}"), top.hospital_event_schema())
    ckpt = st.StreamCheckpoint(str(tmp_path / f"ckpt_{tag}"))
    fw = top.DataFirewall(top.hospital_event_schema()) if firewall else None
    cls = st.PipelinedStreamExecution if pipelined else st.StreamExecution
    if pkg != "jax":
        kw["device"] = "cpu"
    return cls(source=src, sink=sink, checkpoint=ckpt, foreach_batch=foreach,
               firewall=fw, watermark=watermark, replay_backoff=FAST, **kw)


def _features_of(sink):
    return np.asarray(sink.read().numeric_matrix(FEATURES), np.float64)


def _wal_summary(ckpt):
    """(batch_id → files) from offsets + the committed id set."""
    offsets = {int(e["batch_id"]): list(e["files"])
               for e in read_lines(os.path.join(ckpt.path, "offsets.log"))}
    commits = {int(e["batch_id"]) for e in read_lines(os.path.join(ckpt.path, "commits.log"))}
    return offsets, commits


def _infos(infos):
    return [(i.batch_id, i.num_input_rows, i.num_appended_rows, i.num_rejected_rows,
             [os.path.basename(f) for f in i.files], i.status) for i in infos]


def _stage_x(t):
    return t.numeric_matrix(FEATURES).astype(np.float32)


def _sk(**kw):
    kw.setdefault("k", 3)
    kw.setdefault("seed", 0)
    return P.StreamingKMeans(**kw)


# ================================================================ parity
def test_pipelined_matches_serial_end_to_end(tmp_path):
    """Same files → same batches, same sink rows, same WAL lines, and
    bit-identical StreamingKMeans state."""
    (tmp_path / "incoming").mkdir()
    _drop_fleet(tmp_path / "incoming", n_files=5, rows=200)
    sk_s = _sk()
    ser = _build(tmp_path, False, "s",
                 foreach=lambda t, b: sk_s.update(_stage_x(t), device="cpu"))
    infos_s = ser.run(max_batches=5, timeout_s=30)
    sk_p = _sk()
    pipe = _build(tmp_path, True, "p")
    pipe.stage = _stage_x
    pipe.foreach_batch = lambda x, b: sk_p.update(x, device="cpu")
    with pipe:
        infos_p = pipe.run(max_batches=5, timeout_s=30)
    assert _infos(infos_s) == _infos(infos_p)
    np.testing.assert_array_equal(_features_of(ser.sink), _features_of(pipe.sink))
    assert _wal_summary(ser.checkpoint) == _wal_summary(pipe.checkpoint)
    for log in ("offsets.log", "commits.log"):
        assert (read_lines(os.path.join(ser.checkpoint.path, log))
                == read_lines(os.path.join(pipe.checkpoint.path, log))), log
    np.testing.assert_array_equal(sk_s.latest_model.cluster_centers,
                                  sk_p.latest_model.cluster_centers)
    np.testing.assert_array_equal(sk_s.latest_model.cluster_weights,
                                  sk_p.latest_model.cluster_weights)
    # the clock saw the worker's and the commit thread's stages
    assert set(pipe.clock.counts) == {"ingest", "stage", "update"}
    assert pipe.clock.counts["update"] == 5
    assert ser.run_once() is None and pipe.run_once() is None


def test_pipelined_matches_the_jax_package(tmp_path):
    """The port's and the JAX package's pipelined streams over the same
    dirty drops: the same batches, rejects, quarantine evidence and WAL."""
    (tmp_path / "incoming").mkdir()
    _drop_fleet(tmp_path / "incoming", n_files=4, rows=60, dirty=True)
    runs = {}
    for pkg in ("jax", "port"):
        ex = _build(tmp_path, True, pkg, firewall=True, pkg=pkg)
        with ex:
            runs[pkg] = (ex, ex.run(max_batches=4, timeout_s=30))
    (je, ji), (pe, pi) = runs["jax"], runs["port"]
    assert _infos(pi) == _infos(ji)
    np.testing.assert_array_equal(_features_of(pe.sink), _features_of(je.sink))

    def strip(recs):
        return [{k: v for k, v in r.items() if k != "quarantined_at"} for r in recs]

    assert strip(pe.checkpoint.quarantined_rows()) == strip(je.checkpoint.quarantined_rows())
    assert pe.checkpoint.row_reason_histogram() == je.checkpoint.row_reason_histogram()
    for log in ("offsets.log", "commits.log"):
        assert (read_lines(os.path.join(pe.checkpoint.path, log))
                == read_lines(os.path.join(je.checkpoint.path, log))), log


def test_pipelined_matches_serial_quarantine(tmp_path):
    """Dirty fleet: the pipelined firewall quarantines EXACTLY the serial
    rows — same files, same line numbers, same reasons, same counters."""
    (tmp_path / "incoming").mkdir()
    _drop_fleet(tmp_path / "incoming", n_files=5, rows=50, dirty=True)
    ser = _build(tmp_path, False, "s", firewall=True)
    infos_s = ser.run(max_batches=5, timeout_s=30)
    pipe = _build(tmp_path, True, "p", firewall=True)
    with pipe:
        infos_p = pipe.run(max_batches=5, timeout_s=30)

    def strip(recs):
        return [{k: v for k, v in r.items() if k != "quarantined_at"} for r in recs]

    assert strip(ser.checkpoint.quarantined_rows()) == strip(pipe.checkpoint.quarantined_rows())
    assert ser.checkpoint.quarantined_row_count() == pipe.checkpoint.quarantined_row_count() > 0
    assert ser.checkpoint.row_reason_histogram() == pipe.checkpoint.row_reason_histogram()
    assert (ser.metrics.counters.get("stream.rows_rejected")
            == pipe.metrics.counters.get("stream.rows_rejected"))
    assert [i.num_rejected_rows for i in infos_s] == [i.num_rejected_rows for i in infos_p]
    np.testing.assert_array_equal(_features_of(ser.sink), _features_of(pipe.sink))


def test_staged_payload_respects_watermark_filtering(tmp_path):
    """Late rows the watermark drops must never train the model: the
    worker stages the PRE-filter table, so the stream re-stages from the
    filtered table whenever filtering removed rows."""
    (tmp_path / "incoming").mkdir()
    rng = np.random.default_rng(11)
    # file 0 advances the watermark to minute 50; file 1's rows sit at
    # minute 0 — ALL late, all dropped.  Names force processing order.
    for i, (name, start, n) in enumerate((("00.csv", 60, 40), ("01.csv", 0, 10))):
        _event_csv(str(tmp_path / "incoming" / name), start, n, rng)
        os.utime(tmp_path / "incoming" / name, ns=(10**18 + i, 10**18 + i))

    def run(pipelined, tag):
        sk = _sk(k=2, decay_factor=0.9)
        wm = WatermarkTracker("event_time", 10.0)
        if pipelined:
            ex = _build(tmp_path, True, tag, watermark=wm)
            ex.stage = _stage_x
            ex.foreach_batch = lambda x, b: sk.update(x, device="cpu") if len(x) else None
            with ex:
                infos = ex.run(max_batches=2, timeout_s=30)
        else:
            ex = _build(tmp_path, False, tag, watermark=wm,
                        foreach=lambda t, b: sk.update(_stage_x(t), device="cpu")
                        if t.num_rows else None)
            infos = ex.run(max_batches=2, timeout_s=30)
        return sk, infos

    sk_s, infos_s = run(False, "ws")
    sk_p, infos_p = run(True, "wp")
    assert [i.num_late_rows for i in infos_s] == [0, 10]
    assert [i.num_late_rows for i in infos_p] == [0, 10]
    np.testing.assert_array_equal(sk_s.latest_model.cluster_centers,
                                  sk_p.latest_model.cluster_centers)
    assert sk_s._steps == sk_p._steps == 1


def test_backlog_drains_through_update_many(tmp_path):
    """A pre-dropped backlog coalesces into update_many drains and lands
    on the serial per-batch reference's centers."""
    (tmp_path / "incoming").mkdir()
    _drop_fleet(tmp_path / "incoming", n_files=6, rows=150)
    sk_s = _sk()
    ser = _build(tmp_path, False, "s",
                 foreach=lambda t, b: sk_s.update(_stage_x(t), device="cpu"))
    ser.run(max_batches=6, timeout_s=30)
    sk_p = _sk()
    pipe = _build(tmp_path, True, "p", pipeline_depth=4)
    cons = ModelUpdateConsumer(sk_p, pipeline=pipe, device="cpu")
    pipe.stage = _stage_x
    pipe.foreach_batch = cons
    with pipe:
        # let the worker run ahead so a backlog exists when batch 0 commits
        deadline = time.monotonic() + 10
        pipe._ensure_prefetcher()
        while pipe.ready_depth() < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        pipe.run(max_batches=6, timeout_s=30)
        cons.flush()
    assert cons.batches_drained > 0  # the backlog actually coalesced
    assert cons.batches_drained + cons.updates == 6
    np.testing.assert_allclose(sk_s.latest_model.cluster_centers,
                               sk_p.latest_model.cluster_centers, rtol=1e-5, atol=1e-6)


def test_flush_drains_in_powers_of_two():
    """8 + 2 + 1 buffered batches drain as update_many(8), update_many(2)
    and one update, in order, the same sequence as 11 updates."""
    rng = np.random.default_rng(0)
    batches = [rng.normal(size=(32, 2)).astype(np.float32) for _ in range(11)]
    sizes = []

    class Recorder:
        def update(self, b, device=None):
            sizes.append(1)

        def update_many(self, bs, device=None):
            sizes.append(len(bs))

    cons = ModelUpdateConsumer(Recorder(), device="cpu")
    cons._buf = list(batches)
    cons.flush()
    assert sizes == [8, 2, 1] and cons.batches_drained == 10 and cons.updates == 1
    a, b = _sk(k=2), _sk(k=2)
    cons = ModelUpdateConsumer(a, device="cpu")
    cons._buf = list(batches)
    cons.flush()
    for x in batches:
        b.update(x, device="cpu")
    np.testing.assert_array_equal(a.latest_model.cluster_centers, b.latest_model.cluster_centers)


# ============================================================== durability
PIPELINE_KILL_SITES = [
    "stream.after_offsets",
    "stream.after_read",
    "stream.after_foreach",
    "stream.after_sink",
    "stream.after_commit",
    "source.read_file",   # dies on the WORKER thread, mid-parse
]


@pytest.mark.parametrize("site", PIPELINE_KILL_SITES)
def test_pipeline_killed_mid_batch_resumes_exactly_once(tmp_path, site):
    """Kill the pipelined stream at every lifecycle boundary — a crash on
    the prefetch worker included — then restart (pipelined again) and
    drain: every row exactly once, no quarantines, ids contiguous."""
    (tmp_path / "incoming").mkdir()
    _drop_fleet(tmp_path / "incoming", n_files=3, rows=100)
    pipe = _build(tmp_path, True, "c")
    with pipe:
        plan = faults.FaultPlan().crash(site)
        if site == "source.read_file":
            # the worker prefetches ahead, so a parse-time kill is armed
            # before the first batch is read
            with faults.active(plan):
                with pytest.raises(faults.InjectedCrash):
                    pipe.run_once()
            assert plan.fired(site) >= 1
        else:
            assert pipe.run_once().num_appended_rows == 100  # batch 0 clean
            with faults.active(plan):
                with pytest.raises(faults.InjectedCrash):
                    pipe.run_once()
            assert plan.fired(site) == 1
    pipe2 = _build(tmp_path, True, "c")
    with pipe2:
        infos = []
        while (info := pipe2.run_once()) is not None:
            infos.append(info)
        assert pipe2.sink.read().num_rows == 300
        assert pipe2.checkpoint.quarantine_count() == 0
        assert pipe2.sink.max_batch_id() == 2
    assert all(i.status == "ok" for i in infos)


def test_pipeline_replay_does_not_double_count_quarantine(tmp_path):
    """Kill after the sink on a DIRTY batch; the replay must not
    double-count quarantined rows nor duplicate sink rows."""
    (tmp_path / "incoming").mkdir()
    _drop_fleet(tmp_path / "incoming", n_files=2, rows=50, dirty=True)
    pipe = _build(tmp_path, True, "q", firewall=True)
    with pipe:
        pipe.run_once()
        plan = faults.FaultPlan().crash("stream.after_sink")
        with faults.active(plan):
            with pytest.raises(faults.InjectedCrash):
                pipe.run_once()
    pipe2 = _build(tmp_path, True, "q", firewall=True)
    with pipe2:
        while pipe2.run_once() is not None:
            pass
        assert pipe2.checkpoint.quarantined_row_count() == 2
        assert pipe2.metrics.counters.get("stream.rows_rejected") == 2
        assert pipe2.sink.read().num_rows == 50 + 48


def test_pipeline_in_session_replay_rereads_serially(tmp_path):
    """A transient foreach failure replays the batch in-session while the
    worker is alive: the replay re-reads serially and the stream
    completes with exact totals."""
    (tmp_path / "incoming").mkdir()
    _drop_fleet(tmp_path / "incoming", n_files=3, rows=80)
    boom = {"armed": True}

    def flaky_foreach(batch, batch_id):
        if batch_id == 1 and boom.pop("armed", False):
            raise RuntimeError("transient consumer failure")

    pipe = _build(tmp_path, True, "ir", foreach=flaky_foreach, firewall=True)
    with pipe:
        infos = []
        while (info := pipe.run_once()) is not None:
            infos.append(info)
    assert [i.status for i in infos] == ["ok"] * 3
    assert pipe.sink.read().num_rows == 240
    assert pipe.metrics.counters.get("stream.batch_failures") == 1
    # batch 1 read twice: once prefetched, once replayed
    assert pipe.firewall.rows_in == 240 + 80


@pytest.mark.parametrize("pipelined", [False, True], ids=["serial", "pipelined"])
def test_in_session_crash_loop_quarantines_at_budget(tmp_path, pipelined):
    """A stream looped in-session over an escaping crash re-polls the
    same files under the same batch id; once the durable attempt budget
    is spent the batch quarantines instead of retrying forever."""
    (tmp_path / "incoming").mkdir()
    _drop_fleet(tmp_path / "incoming", n_files=1, rows=40)
    exec_ = _build(tmp_path, pipelined, "bl", max_batch_replays=2)
    plan = faults.FaultPlan().fail(
        "stream.after_read", times=None,
        error=lambda: faults.InjectedCrash("kill every attempt"),
    )
    try:
        with faults.active(plan):
            for _ in range(2):
                with pytest.raises(faults.InjectedCrash):
                    exec_.run_once()
            info = exec_.run_once()  # budget (2) spent → quarantined
        assert info.status == "quarantined"
        assert exec_.checkpoint.quarantine_count() == 1
        assert exec_.sink.read().num_rows == 0
        offsets, commits = _wal_summary(exec_.checkpoint)
        assert offsets[info.batch_id] == info.files
        assert info.batch_id in commits
        assert exec_.run_once() is None  # the stream moved on
    finally:
        if pipelined:
            exec_.close()


def test_max_files_per_batch_caps_poll(tmp_path):
    (tmp_path / "incoming").mkdir()
    _drop_fleet(tmp_path / "incoming", n_files=4, rows=20)
    src = FileStreamSource(str(tmp_path / "incoming"), P.hospital_event_schema(),
                           max_files_per_batch=3)
    first = src.poll()
    assert len(first) == 3
    gen = src.seen_generation()
    src.commit_files(first)
    assert src.seen_generation() == gen + 1
    assert src.seen_snapshot() == frozenset(first)
    assert len(src.poll()) == 1


def test_worker_discovery_failure_surfaces_instead_of_hanging(tmp_path):
    """A listing failure on the worker thread surfaces from run_once like
    a serial poll() failure — not a stream spinning on a dead worker."""
    (tmp_path / "incoming").mkdir()
    _drop_fleet(tmp_path / "incoming", n_files=1, rows=20)
    pipe = _build(tmp_path, True, "d")

    def boom():
        raise OSError("mount fell over")

    pipe.source.list_files = boom
    with pipe:
        with pytest.raises(OSError, match="mount fell over"):
            pipe.run_once()


def test_pipeline_recovers_after_transient_discovery_error(tmp_path):
    """After a surfaced worker error the next run_once spawns a fresh
    worker and ingests normally."""
    (tmp_path / "incoming").mkdir()
    _drop_fleet(tmp_path / "incoming", n_files=1, rows=30)
    pipe = _build(tmp_path, True, "r")
    real_list = pipe.source.list_files
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("transient blip")
        return real_list()

    pipe.source.list_files = flaky
    with pipe:
        with pytest.raises(OSError, match="transient blip"):
            pipe.run_once()
        info = pipe.run_once()  # fresh worker, same stream object
        assert info is not None and info.num_appended_rows == 30


def test_a_worker_error_is_raised_inside_the_attempt(tmp_path):
    """A prefetched batch carrying the worker's error: the intent and the
    attempt are on disk before the error surfaces."""
    (tmp_path / "incoming").mkdir()
    _drop_fleet(tmp_path / "incoming", n_files=1, rows=10)
    ex = _build(tmp_path, False, "e")
    files = ex.source.poll()
    ex.checkpoint.begin_batch(0, files, {})
    with pytest.raises(ValueError, match="parse died"):
        ex._attempt(0, files, {}, Prefetched(files=files, error=ValueError("parse died")))
    assert ex.checkpoint.attempts(0) == 1
    assert StreamCheckpoint(ex.checkpoint.path).recover()["pending"]["files"] == files


def test_add_ingest_time_switch(tmp_path):
    (tmp_path / "incoming").mkdir()
    _drop_fleet(tmp_path / "incoming", n_files=1, rows=10)
    seen = []
    ex = _build(tmp_path, False, "n", foreach=lambda t, b: seen.append(t.schema.names),
                add_ingest_time=False)
    ex.run(max_batches=1, timeout_s=10)
    assert "ingest_time" not in seen[0]
    ex2 = _build(tmp_path, False, "y", foreach=lambda t, b: seen.append(t.schema.names))
    ex2.run(max_batches=1, timeout_s=10)
    assert seen[1][-1] == "ingest_time"


# ============================================================ the consumer
def test_consumer_counts_tuple_batch_rows_correctly():
    """A staged (x, w) TUPLE with zero rows reads as empty (len() of the
    tuple would say 2) — and a non-empty tuple as its row count."""
    assert batch_rows((np.zeros((0, 3), np.float32), np.zeros(0))) == 0
    assert batch_rows((np.zeros((7, 3), np.float32), np.zeros(7))) == 7
    assert batch_rows(torch.zeros((5, 2))) == 5
    assert batch_rows(P.device_dataset(np.zeros((6, 2)), device="cpu")) == 6
    sk = _sk(k=2)
    cons = ModelUpdateConsumer(sk, device="cpu")
    cons((np.zeros((0, 2), np.float32), np.zeros(0, np.float32)), 0)
    assert sk._steps == 0


def test_consumer_decays_empty_batches_after_init():
    """An EMPTY committed batch still applies the decay step to an
    initialized model; before any rows arrive, empties are skipped."""
    rng = np.random.default_rng(0)
    sk = _sk(k=2, decay_factor=0.5)
    cons = ModelUpdateConsumer(sk, device="cpu")
    cons(np.zeros((0, 2), np.float32), 0)   # pre-init empty: skipped
    assert sk._steps == 0
    cons(rng.normal(size=(64, 2)).astype(np.float32), 1)
    w1 = float(np.sum(sk.latest_model.cluster_weights))
    cons(np.zeros((0, 2), np.float32), 2)   # post-init empty: decays
    assert sk._steps == 2
    w2 = float(np.sum(sk.latest_model.cluster_weights))
    assert w2 == pytest.approx(0.5 * w1, rel=1e-6)


def test_sql_feature_stage_equals_the_jax_package(tmp_path):
    """The SQL stage hook on one micro-batch: the interpreter route ``==``
    the JAX package's stage on the same table."""
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu.streaming.pipeline import (
        make_sql_feature_stage as jax_stage,
    )

    rng = np.random.default_rng(3)
    path = str(tmp_path / "b.csv")
    _event_csv(path, 0, 50, rng)
    stmt = ("SELECT admission_count, current_occupancy * 2 AS occ2, length_of_stay "
            "FROM __THIS__ WHERE admission_count > 10")
    cols = ["admission_count", "occ2"]
    x, y = make_sql_feature_stage(stmt, cols, "length_of_stay", min_compiled_rows=10**9,
                                  device="cpu")(P.read_csv(path, P.hospital_event_schema()))
    jx, jy = jax_stage(stmt, cols, "length_of_stay", min_compiled_rows=10**9)(
        J.read_csv(path, J.hospital_event_schema()))
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    with pytest.raises(KeyError, match="__THIS__"):
        make_sql_feature_stage("SELECT * FROM events", cols, device="cpu")(
            P.read_csv(path, P.hospital_event_schema()))


def test_knobs_are_read_at_their_call_sites(tmp_path):
    """``stream.pipeline.depth`` and ``stream.worker.poll_interval_ms``
    size the worker when the stream leaves them unset, and
    ``sql.stage.min_compiled_rows`` picks the SQL stage's route."""
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core import sql
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.tune import knob

    (tmp_path / "incoming").mkdir()
    pipe = _build(tmp_path, True, "k")
    with pipe:
        pf = pipe._ensure_prefetcher()
        assert pf.queue.maxsize == int(knob("stream.pipeline.depth")) == 2
        assert pf.poll_interval_s == knob("stream.worker.poll_interval_ms") / 1e3
    rng = np.random.default_rng(4)
    path = str(tmp_path / "b.csv")
    _event_csv(path, 0, 40, rng)
    table = P.read_csv(path, P.hospital_event_schema())
    stage = make_sql_feature_stage("SELECT admission_count FROM __THIS__", ["admission_count"],
                                   device="cpu")
    assert len(table) < int(knob("sql.stage.min_compiled_rows"))
    np.testing.assert_array_equal(stage(table), _stage_x(table)[:, :1])
    assert sql.last_dispatch().route == "interpreter"


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: ModelUpdateConsumer(_sk()),
                 lambda: make_sql_feature_stage("SELECT * FROM __THIS__", ["a"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ================================================================ profiling
def test_stage_clock_sums_stages_and_emits_spans():
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.obs import trace

    clock = profiling.StageClock()
    with clock.stage("a"):
        time.sleep(0.01)
    with clock.stage("b"):
        pass
    with clock.stage("a"):
        pass
    assert clock.counts == {"a": 2, "b": 1}
    shares = clock.shares()
    assert list(shares) == ["a", "b"] and abs(sum(shares.values()) - 1.0) < 1e-12
    assert profiling.StageClock().shares() == {}
    assert not trace.enabled()


def test_host_sync_census_keys_and_cpu_counts():
    """The reference's dict keys; on the CPU nothing syncs or copies to a
    card, so both counts stay 0."""
    with profiling.host_sync_census(count_puts=True) as c:
        t = torch.ones(8)
        float(t.sum())
        t.cpu().numpy()
    assert c == {"device_get": 0, "device_put": 0}


def test_capture_trace_holds_the_annotation(tmp_path):
    with profiling.capture_trace(str(tmp_path / "tr")) as prof:
        with profiling.trace_annotation("fed.round.test"):
            torch.ones(64).sum()
    assert os.path.isfile(tmp_path / "tr" / "trace.json")
    assert "fed.round.test" in {e.name for e in prof.events()}
    assert "fed.round.test" in (tmp_path / "tr" / "trace.json").read_text()


def test_device_fence_walks_objects_and_warns_on_nothing():
    m = P.KMeans(k=2).fit(np.random.default_rng(0).normal(size=(20, 2)), device="cpu")
    x = torch.ones(3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        profiling.device_fence(m, [x, {"a": x}], None)
        assert profiling.block_until_ready(x) is x
    with pytest.warns(RuntimeWarning, match="nothing was fenced"):
        profiling.device_fence(object())

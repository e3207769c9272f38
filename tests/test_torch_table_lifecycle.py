"""The table lifecycle (seal, retire, scrub) and the pruned scan: the
port's ``core/table_lifecycle.py`` and ``streaming/unbounded_table.py``
against the JAX package's, on the CPU.

The lifecycle and the reads are host work on the same Parquet bytes, so
every comparison is exact: snapshots column by column (``tobytes``,
strings as lists), commit-log entries, ``prune_stats`` and ``explain``
as dicts.  The port's pruned scan runs compiled on ``device="cpu"`` and
is held ``==`` to the JAX package's interpreter on the same rows: a
row-level query only masks and gathers, so there is nothing to round.
No test calls the JAX compiled route.  Tables cross packages both ways:
one the JAX lifecycle sealed and retired reads ``==`` in the port, and
one the port sealed reads ``==`` in the JAX package.
"""

import errno
import os

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.core import sql as Jsql
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.core import (
    table_lifecycle as JL,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.streaming import (
    unbounded_table as JU,
)
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core import sql as Psql
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core import (
    table_lifecycle as PL,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core.segments import (
    SegmentCorruptError,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.obs.registry import (
    global_registry,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.streaming import (
    unbounded_table as PU,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import faults

# the suite runs several worker processes on a few cores: one intra-op
# thread per worker keeps torch from oversubscribing them
torch.set_num_threads(1)

PKG = {"jax": (J, JU, JL), "port": (P, PU, PL)}


def _policy(pkg="port", **kw):
    args = dict(min_seal_batches=2, hot_batches=2, max_segment_batches=3)
    args.update(kw)
    return PKG[pkg][2].RetentionPolicy(**args)


def _batch(bid, n=6, pkg="port"):
    """Batch ``bid``'s rows: i1 lives in [bid*10, bid*10+n) so zone maps
    are disjoint per batch and pruning is decidable per segment; a string
    column rides along."""
    t1 = (np.datetime64("2025-03-31T22:00:00") + np.timedelta64(bid, "h")
          + np.arange(n).astype("timedelta64[s]")).astype("datetime64[ns]")
    return PKG[pkg][0].Table.from_dict({
        "f1": np.arange(n, dtype=np.float64) + bid,
        "i1": np.arange(n) + bid * 10,
        "t1": t1,
        "s1": np.array([f"H{(bid + j) % 3}" for j in range(n)], object),
    })


def _mk(tmp_path, n_batches=8, pkg="port", name="tbl"):
    U = PKG[pkg][1]
    tbl = U.UnboundedTable(str(tmp_path / name), _batch(0, 1, pkg).schema, name="events")
    for bid in range(n_batches):
        tbl.append_batch(_batch(bid, pkg=pkg), bid)
    return tbl


def _reopen(tbl, pkg="port"):
    return PKG[pkg][1].UnboundedTable(tbl.path, tbl.schema, name="events")


def _same(a, b):
    """Two tables (either package) with the same columns, dtypes and
    bytes; strings as lists."""
    assert list(a.columns) == list(b.columns)
    assert len(a) == len(b)
    for c in a.columns:
        va, vb = a.column(c), b.column(c)
        assert va.dtype == vb.dtype, c
        if va.dtype == object:
            assert va.tolist() == vb.tolist(), c
        else:
            assert va.tobytes() == vb.tobytes(), c


def _flip(path, at=None):
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2 if at is None else at] ^= 0x01
    with open(path, "wb") as f:
        f.write(bytes(blob))


def _segments(tbl):
    return sorted(f for f in os.listdir(tbl.segments_dir) if f.endswith(".parquet"))


def _counter(name):
    return global_registry().counters.get(name, 0.0)


def _log(tbl):
    return [{k: v for k, v in e.items()} for e in tbl._log_entries()]


# ============================================================ policy
def test_retention_defaults_are_the_reference_knob_defaults():
    mine, ref = PL.RetentionPolicy(), JL.RetentionPolicy()
    assert (mine.min_seal_batches, mine.max_segment_batches) == (4, 64)
    assert (ref.min_seal_batches, ref.max_segment_batches) == (4, 64)
    assert mine == PL.RetentionPolicy(min_seal_batches=4, max_segment_batches=64)


# ====================================================== seal / retire
def test_seal_retire_preserves_rows_and_order_and_logs_the_reference_entries(tmp_path):
    mine, ref = _mk(tmp_path, pkg="port", name="p"), _mk(tmp_path, pkg="jax", name="j")
    before = mine.read()
    sealed0, retired0 = _counter("table.segments_sealed"), _counter("table.parts_retired")
    out = PL.TableLifecycle(mine, _policy()).tick()
    assert out == JL.TableLifecycle(ref, _policy("jax")).tick() == {"sealed": 2, "retired": 6}
    assert _counter("table.segments_sealed") - sealed0 == 2
    assert _counter("table.parts_retired") - retired0 == 6
    _same(_reopen(mine).read(), before)
    _same(_reopen(mine).read(), _reopen(ref, "jax").read())
    # the same commit-log lines (CRC records included) and files
    assert _log(mine) == _log(ref)
    assert sorted(os.listdir(mine.path)) == sorted(os.listdir(ref.path))
    assert _segments(mine) == _segments(ref)
    left = sorted(f for f in os.listdir(mine.path) if f.startswith("part-"))
    assert left == ["part-0000000006.parquet", "part-0000000007.parquet"]


def test_seal_is_idempotent_and_respects_min_batches(tmp_path):
    tbl = _mk(tmp_path)
    lc = PL.TableLifecycle(tbl, _policy())
    assert lc.seal() == 2
    assert lc.seal() == 0                     # nothing cold left uncovered
    assert PL.TableLifecycle(tbl, _policy(min_seal_batches=64)).seal() == 0
    assert lc.retire() == 6 and lc.retire() == 0


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_watermark_keeps_hot_event_times_unsealed(tmp_path, pkg):
    tbl = _mk(tmp_path, pkg=pkg)
    pol = _policy(pkg, min_seal_batches=1, hot_batches=0, max_segment_batches=2,
                  watermark_column="t1")
    wm = np.datetime64("2025-03-31T22:00:00") + np.timedelta64(4, "h")
    PKG[pkg][2].TableLifecycle(tbl, pol).seal(watermark=wm)
    covered = {int(b["batch_id"]) for s in tbl._committed_state()[1] for b in s["batches"]}
    assert covered == {0, 1, 2, 3}
    # an integer watermark in ns is the same cut
    tbl2 = _mk(tmp_path, pkg=pkg, name="t2")
    PKG[pkg][2].TableLifecycle(tbl2, pol).seal(watermark=int(wm.astype("datetime64[ns]").view("i8")))
    assert _log(tbl2) == _log(tbl)


def test_empty_and_replayed_batches_survive_sealing(tmp_path):
    tbl = _mk(tmp_path, n_batches=6)
    tbl.append_batch(_batch(6, n=0), 6)                 # empty committed batch
    PL.TableLifecycle(tbl, _policy(hot_batches=0, max_segment_batches=8)).tick()
    rows = tbl.num_rows()
    # replay a sealed batch with other rows: the later commit entry
    # supersedes the sealed copy, and retention keeps its part
    tbl.append_batch(_batch(2).with_column("f1", np.full(6, 999.0)), 2)
    snap = _reopen(tbl).read()
    assert len(snap) == rows and int((snap["f1"] == 999.0).sum()) == 6
    PL.TableLifecycle(_reopen(tbl), _policy()).retire()
    assert os.path.exists(os.path.join(tbl.path, "part-0000000002.parquet"))
    _same(_reopen(tbl).read(), snap)
    _same(JU.UnboundedTable(tbl.path, tbl.schema).read(), snap)


# ============================================================== scrub
def test_scrub_detects_a_flipped_byte_quarantines_and_rebuilds(tmp_path):
    tbl = _mk(tmp_path)
    before = tbl.read()
    keep = _policy(retire_parts=False)
    PL.TableLifecycle(tbl, keep).seal()
    _flip(os.path.join(tbl.segments_dir, _segments(tbl)[0]))
    repairs0 = _counter("table.scrub_repairs")
    assert PL.TableLifecycle(tbl, keep).scrub() == {"checked": 2, "repaired": 1, "quarantined": 0}
    assert _counter("table.scrub_repairs") - repairs0 == 1
    assert any(f.endswith(".quarantine") for f in os.listdir(tbl.segments_dir))
    assert {"scrub": {"file": _segments(tbl)[0], "action": "rebuild"}} in _log(tbl)
    _same(_reopen(tbl).read(), before)
    assert PL.TableLifecycle(_reopen(tbl), keep).scrub()["repaired"] == 0
    _same(JU.UnboundedTable(tbl.path, tbl.schema).read(), before)


def test_scrub_with_retired_parts_quarantines_loudly(tmp_path):
    tbl = _mk(tmp_path)
    PL.TableLifecycle(tbl, _policy()).tick()          # parts retired: no rebuild source
    _flip(os.path.join(tbl.segments_dir, _segments(tbl)[0]))
    with pytest.raises(SegmentCorruptError, match="no surviving parts"):
        PL.TableLifecycle(tbl).scrub()
    assert any(e.get("scrub", {}).get("action") == "quarantine" for e in _log(tbl))
    with pytest.raises(SegmentCorruptError):
        _reopen(tbl).read()


def test_rotten_segment_reads_from_surviving_parts(tmp_path):
    tbl = _mk(tmp_path)
    before = tbl.read()
    PL.TableLifecycle(tbl, _policy(retire_parts=False)).seal()
    for seg in _segments(tbl):
        _flip(os.path.join(tbl.segments_dir, seg))
    _same(_reopen(tbl).read(), before)
    # retire refuses to delete parts a rotten segment claims to serve
    assert PL.TableLifecycle(tbl, _policy()).retire() == 0


def test_rotten_segment_with_a_retired_part_raises(tmp_path):
    tbl = _mk(tmp_path)
    PL.TableLifecycle(tbl, _policy()).tick()
    _flip(os.path.join(tbl.segments_dir, _segments(tbl)[1]))
    with pytest.raises(SegmentCorruptError, match="unrecoverable"):
        _reopen(tbl).read()
    with pytest.raises(SegmentCorruptError):
        _reopen(tbl).read_sealed_batch(4)
    assert _reopen(tbl).read_sealed_batch(0) is not None


# ============================================================ pruning
PRUNE_QUERIES = [
    "SELECT i1, f1 FROM events WHERE i1 >= 65",
    "SELECT i1 FROM events WHERE f1 != 3.0",
    "SELECT i1, s1 FROM events WHERE i1 < 25 OR i1 > 72",
    "SELECT * FROM events WHERE t1 >= '2025-04-01 03:00:00'",
    "SELECT i1 FROM events WHERE NOT (i1 BETWEEN 0 AND 25)",
    "SELECT i1 FROM events WHERE i1 IN (3, 54, 71)",
    "SELECT f1 FROM events WHERE i1 > 1000",
]


@pytest.mark.parametrize("q", PRUNE_QUERIES)
def test_pruned_compiled_scan_equals_the_reference_interpreter(tmp_path, q):
    mine, ref = _mk(tmp_path, 10, name="p"), _mk(tmp_path, 10, pkg="jax", name="j")
    PL.TableLifecycle(mine, _policy()).tick()
    JL.TableLifecycle(ref, _policy("jax")).tick()
    got = Psql.execute(q, lambda _n: mine.read(), device="cpu")
    assert Psql.last_dispatch().route == "compiled"
    _same(got, Jsql.execute(q, lambda _n: ref.read(), mode="interpret"))
    _same(got, Psql.execute(q, lambda _n: mine.read(), mode="interpret"))
    # explain (the prune preview included) is the reference's
    assert Psql.explain(q, lambda _n: mine.read()) == Jsql.explain(q, lambda _n: ref.read())


def test_not_between_keeps_a_segment_it_overlaps(tmp_path):
    """NOT BETWEEN over a range that overlaps a segment keeps it: the
    port's preview prunes one segment where the JAX package's prunes two
    (its evaluator's fault, ROADMAP queue 3); the rows are the
    reference interpreter's either way."""
    mine, ref = _mk(tmp_path, 10, name="p"), _mk(tmp_path, 10, pkg="jax", name="j")
    PL.TableLifecycle(mine, _policy()).tick()
    JL.TableLifecycle(ref, _policy("jax")).tick()
    q = "SELECT i1 FROM events WHERE NOT (i1 BETWEEN 0 AND 44)"
    got = Psql.execute(q, lambda _n: mine.read(), device="cpu")
    _same(got, Jsql.execute(q, lambda _n: ref.read(), mode="interpret"))
    assert got["i1"].min() == 45
    assert Psql.explain(q, lambda _n: mine.read())["prune"]["segments_pruned"] == 1
    assert Jsql.explain(q, lambda _n: ref.read())["prune"]["segments_pruned"] == 2


def test_prune_stats_report_the_skipped_segments(tmp_path):
    tbl = _mk(tmp_path, 10)
    PL.TableLifecycle(tbl, _policy()).tick()
    q = "SELECT i1, f1 FROM events WHERE i1 >= 65"
    prune = Psql.explain(q, lambda _n: tbl.read())["prune"]
    # 8 cold batches chunk into [0-2][3-5][6-7]; i1 >= 65 lands in batch
    # 6's zone, so exactly the first two segments prune away
    assert prune == {"segments": 3, "segments_pruned": 2, "rows_pruned": 36, "parts_scanned": 2}
    skipped0 = _counter("table.segments_prune_skipped")
    Psql.execute(q, lambda _n: tbl.read(), device="cpu")
    assert _counter("table.segments_prune_skipped") - skipped0 == 2
    pinned = tbl.prune_stats(("cmp", "i1", "<", 25), upto_batch_id=4)
    assert pinned == {"segments": 2, "segments_pruned": 1, "rows_pruned": 12, "parts_scanned": 0}


def test_pinned_reads_prune_against_the_pinned_assembly(tmp_path):
    tbl = _mk(tmp_path, 10)
    PL.TableLifecycle(tbl, _policy()).tick()
    q = "SELECT i1 FROM events WHERE i1 < 25"
    got = Psql.execute(q, lambda _n: tbl.read(upto_batch_id=4), device="cpu")
    _same(got, Psql.execute(q, lambda _n: tbl.read(upto_batch_id=4), mode="interpret"))
    assert got["i1"].tolist() == list(range(6)) + list(range(10, 16)) + list(range(20, 25))


def test_prune_key_absent_for_plain_tables_and_filterless_queries(tmp_path):
    tbl = _mk(tmp_path)
    PL.TableLifecycle(tbl, _policy()).tick()
    assert "prune" not in Psql.explain("SELECT i1 FROM events WHERE i1 > 3", lambda _n: _batch(0))
    assert "prune" not in Psql.explain("SELECT i1 FROM events", lambda _n: tbl.read())


def test_an_all_pruned_query_gives_an_empty_result(tmp_path):
    tbl = _mk(tmp_path, 6)
    PL.TableLifecycle(tbl, _policy(hot_batches=0, max_segment_batches=8)).tick()
    q = "SELECT i1, f1 FROM events WHERE i1 > 1000"
    out = Psql.execute(q, lambda _n: tbl.read(), device="cpu")
    assert len(out) == 0 and Psql.last_dispatch().route == "compiled"
    _same(out, Psql.execute(q, lambda _n: tbl.read(), mode="interpret"))
    assert tbl.scan_pruned(None, ("cmp", "i1", ">", 1000))[0] is None


def test_the_pruned_scan_hands_back_one_table_between_appends(tmp_path):
    """The memo keyed on the commit log's stat: a repeated query gets the
    same Table, so its device columns keep hitting; an append drops it."""
    tbl = _mk(tmp_path, 10)
    PL.TableLifecycle(tbl, _policy()).tick()
    f = ("cmp", "i1", ">=", 65)
    a, sa = tbl.scan_pruned(None, f)
    b, sb = tbl.scan_pruned(None, f)
    assert a is b and sa == sb and len(a) == 4 * 6
    q = "SELECT i1 FROM events WHERE i1 >= 65"
    Psql.execute(q, lambda _n: tbl.read(), device="cpu")
    hits0 = _counter("sql.cache.device.hit")
    Psql.execute(q, lambda _n: tbl.read(), device="cpu")
    assert _counter("sql.cache.device.hit") > hits0
    tbl.append_batch(_batch(10), 10)
    c, _ = tbl.scan_pruned(None, f)
    assert c is not a and len(c) == 5 * 6
    # nothing pruned: the full memoized snapshot itself
    full, st = tbl.scan_pruned(None, ("cmp", "i1", ">=", 0))
    assert full is tbl.read() and st["segments_pruned"] == 0


def test_a_failed_prune_scans_the_whole_snapshot_and_is_counted(tmp_path, monkeypatch):
    tbl = _mk(tmp_path, 10)
    PL.TableLifecycle(tbl, _policy()).tick()

    def broken(*_a, **_k):
        raise OSError("manifest trouble")

    monkeypatch.setattr(tbl, "scan_pruned", broken)
    errors0 = _counter("table.prune_errors")
    q = "SELECT i1 FROM events WHERE i1 >= 65"
    got = Psql.execute(q, lambda _n: tbl.read(), device="cpu")
    assert _counter("table.prune_errors") - errors0 == 1
    assert Psql.last_dispatch().route == "compiled"
    _same(got, Psql.execute(q, lambda _n: tbl.read(), mode="interpret"))


# ================================================= faults and kills
def test_enospc_at_the_seal_commit_degrades_and_resumes(tmp_path):
    tbl = _mk(tmp_path)
    before = tbl.read()
    plan = faults.FaultPlan().disk_full("table.seal.commit")
    with faults.active(plan):
        with pytest.raises(OSError) as ei:
            PL.TableLifecycle(tbl, _policy()).tick()
    assert ei.value.errno == errno.ENOSPC and plan.fired("table.seal.commit") == 1
    _same(_reopen(tbl).read(), before)
    PL.TableLifecycle(_reopen(tbl), _policy()).tick()
    _same(_reopen(tbl).read(), before)


@pytest.mark.parametrize("site", ["table.seal.stage", "table.seal.commit", "table.retire.commit"])
def test_a_kill_at_each_lifecycle_site_resumes_to_the_same_table(tmp_path, site, monkeypatch):
    monkeypatch.setenv("CMLHN_FLIGHT_DIR", str(tmp_path / "flight"))
    tbl = _mk(tmp_path)
    before = tbl.read()
    plan = faults.FaultPlan().crash(site)
    with faults.active(plan):
        with pytest.raises(faults.InjectedCrash):
            PL.TableLifecycle(tbl, _policy()).tick()
    assert plan.fired(site) == 1
    _same(_reopen(tbl).read(), before)                 # mid-crash state
    PL.TableLifecycle(_reopen(tbl), _policy()).tick()  # the resume finishes
    final = _reopen(tbl)
    _same(final.read(), before)
    retired = {f for e in final._log_entries() if "retire" in e for f in e["retire"]["files"]}
    items, _ = final._assembly()
    for it in items:
        if it[0] == "part":
            assert it[2]["file"] not in retired
            assert os.path.exists(os.path.join(final.path, it[2]["file"]))
    for f in retired:
        assert not os.path.exists(os.path.join(final.path, f))
    # and the resumed table's log is the uninterrupted one's, with the
    # kill's partial staging invisible
    clean = _mk(tmp_path, name="clean")
    PL.TableLifecycle(clean, _policy()).tick()
    assert [e for e in _log(final) if "seal" in e] == [e for e in _log(clean) if "seal" in e]


def test_a_kill_mid_repair_resumes(tmp_path, monkeypatch):
    monkeypatch.setenv("CMLHN_FLIGHT_DIR", str(tmp_path / "flight"))
    tbl = _mk(tmp_path)
    before = tbl.read()
    keep = _policy(retire_parts=False)
    PL.TableLifecycle(tbl, keep).seal()
    _flip(os.path.join(tbl.segments_dir, _segments(tbl)[0]))
    plan = faults.FaultPlan().crash("table.scrub.repair")
    with faults.active(plan):
        with pytest.raises(faults.InjectedCrash):
            PL.TableLifecycle(tbl, keep).scrub()
    assert plan.fired("table.scrub.repair") == 1
    _same(_reopen(tbl).read(), before)                 # parts still serve
    assert PL.TableLifecycle(_reopen(tbl), keep).scrub()["repaired"] == 1
    _same(_reopen(tbl).read(), before)
    assert any(f.endswith(".quarantine") for f in os.listdir(tbl.segments_dir))


# ===================================================== across packages
def test_a_table_the_reference_sealed_and_retired_reads_the_same_in_the_port(tmp_path):
    ref = _mk(tmp_path, 10, pkg="jax")
    JL.TableLifecycle(ref, _policy("jax")).tick()
    want = JU.UnboundedTable(ref.path, ref.schema).read()
    mine = PU.UnboundedTable(ref.path, _batch(0, 1).schema, name="events")
    _same(mine.read(), want)
    for bid in range(10):
        s = mine.read_sealed_batch(bid)
        assert (s is None) == (bid >= 8)
        if s is not None:
            _same(s, _batch(bid))
    # and the port's lifecycle carries on over it: a scrub checks the
    # reference's segments, new batches seal beside them
    assert PL.TableLifecycle(mine, _policy()).scrub()["checked"] == 3
    for bid in range(10, 14):
        mine.append_batch(_batch(bid), bid)
    assert PL.TableLifecycle(mine, _policy()).tick()["sealed"] == 1
    _same(JU.UnboundedTable(ref.path, ref.schema).read(), _reopen(mine).read())


def test_a_table_the_port_sealed_reads_the_same_in_the_reference(tmp_path):
    mine = _mk(tmp_path, 10)
    PL.TableLifecycle(mine, _policy()).tick()
    ref = JU.UnboundedTable(mine.path, _batch(0, 1, "jax").schema, name="events")
    _same(ref.read(), mine.read())
    assert JL.TableLifecycle(ref, _policy("jax")).scrub() == \
        {"checked": 3, "repaired": 0, "quarantined": 0}
    q = "SELECT i1 FROM events WHERE i1 >= 65"
    assert Jsql.explain(q, lambda _n: ref.read())["prune"] == \
        Psql.explain(q, lambda _n: mine.read())["prune"]

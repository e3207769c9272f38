"""Sealed segments: the port's ``core/segments.py`` against the JAX
package's, on the CPU.

Everything here is host work (numpy, pyarrow, CRC32C), so every
comparison is exact: the zone maps as dicts, the evaluator's verdicts,
the manifests, and the rows a segment reads back (``tobytes`` per
column, strings as lists).  The evaluator's grid is lowered by the port's
planner from the fuzz harness's seeded conditions; each verdict is held
to the JAX evaluator's on the same lowered tuple and to the rows: a
segment holding a matching row is never pruned.
"""

import errno
import json
import os
import sys

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.core import segments as JSeg
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core import segments as PSeg
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core import sql as Psql
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core import sql_fuzz
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core.sql_parse import parse
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core.sql_plan import (
    plan_query,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import faults

# the suite runs several worker processes on a few cores: one intra-op
# thread per worker keeps torch from oversubscribing them
torch.set_num_threads(1)

T0 = np.datetime64("2025-03-31T22:00:00", "ns")

#: one column kind each, nulls and all-null included
ZONE_CASES = {
    "float with NaN": {"v": np.array([2.5, np.nan, -1.0, np.inf])},
    "float all NaN": {"v": np.full(3, np.nan)},
    "float empty": {"v": np.zeros(0)},
    "int": {"v": np.array([3, -7, 11], np.int64)},
    "uint": {"v": np.array([3, 0, 11], np.uint32)},
    "bool": {"v": np.array([True, False, True])},
    "timestamp with NaT": {"v": np.array([T0, np.datetime64("NaT", "ns"), T0 + 5])},
    "timestamp all NaT": {"v": np.full(2, np.datetime64("NaT", "ns"))},
    "string (skipped)": {"v": np.array(["H1", None, "H2"], object), "i": np.arange(3)},
}


def _bit_identical(a, b):
    assert list(a.columns) == list(b.columns)
    assert len(a) == len(b)
    for c in a.columns:
        va, vb = a.column(c), b.column(c)
        assert va.dtype == vb.dtype, c
        if va.dtype == object:
            assert va.tolist() == vb.tolist(), c
        else:
            assert va.tobytes() == vb.tobytes(), c


def _rows(n=12, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=n)
    f[::5] = np.nan
    return {
        "f1": f,
        "i1": rng.integers(0, 50, n),
        "t1": (T0 + rng.integers(0, 3600, n).astype("timedelta64[s]")).astype("datetime64[ns]"),
        "s1": np.array([f"H{int(v)}" for v in rng.integers(0, 3, n)], object),
    }


@pytest.mark.parametrize("case", sorted(ZONE_CASES))
def test_zone_maps_equal_the_reference(case):
    cols = ZONE_CASES[case]
    got = PSeg.zone_maps(P.Table.from_dict(cols))
    want = JSeg.zone_maps(J.Table.from_dict(cols))
    assert got == want
    assert json.dumps(got) == json.dumps(want)      # the manifest's bytes too


@pytest.mark.parametrize("seed", range(10))
def test_segment_may_match_equals_the_reference_and_never_prunes_a_match(seed):
    """Random conditions (the fuzz harness's grammar) lowered by the
    port's planner, over random segments of 0 to 24 rows: the port's
    verdict equals the JAX evaluator's on the same tuple, and a segment
    with a row the interpreter keeps answers "may match"."""
    rng = np.random.default_rng(seed)
    prunes = 0
    for _ in range(40):
        table = sql_fuzz.random_table(rng, int(rng.integers(0, 25)))
        cond = sql_fuzz._render_cond(sql_fuzz._random_cond(rng))
        q = f"SELECT i1 FROM fuzz WHERE {cond}"
        plan = plan_query(parse(q), lambda _n, t=table: t)
        if plan is None or plan.filter is None:
            continue
        zones = PSeg.zone_maps(table)
        got = PSeg.segment_may_match(zones, plan.filter)
        want = JSeg.segment_may_match(zones, plan.filter)
        matched = len(Psql.execute(q, lambda _n, t=table: t, mode="interpret"))
        assert got or matched == 0, (q, zones)
        # equal to the reference, but where the reference prunes a
        # segment that holds a matching row (NOT BETWEEN over an
        # overlapping range): there the port answers "may match"
        assert got == want or (not want and matched > 0), (q, zones)
        prunes += not got
    # the grid reaches the "no" answer at all (seed by seed it does)
    assert prunes > 0


def test_not_between_prunes_only_a_segment_inside_the_range():
    """NOT BETWEEN may match iff some value lies outside [a, b]; the JAX
    evaluator answers "no" for any overlap, which the grid above meets
    (ROADMAP queue 3)."""
    zones = PSeg.zone_maps(P.Table.from_dict({"i1": np.arange(6) + 30}))   # [30, 35]
    assert not PSeg.segment_may_match(zones, ("not", ("between", "i1", 30, 35)))
    assert not PSeg.segment_may_match(zones, ("not", ("between", "i1", 0, 99)))
    for a, b in ((32, 40), (20, 33), (31, 34), (40, 50)):
        assert PSeg.segment_may_match(zones, ("not", ("between", "i1", a, b)))
    assert not JSeg.segment_may_match(zones, ("not", ("between", "i1", 32, 40)))


@pytest.mark.parametrize("pred,want", [
    (("cmp", "i1", ">=", 100), False),
    (("cmp", "i1", ">=", 31), True),
    (("cmp", "i1", "=", 7), False),
    (("not", ("cmp", "i1", "=", 31)), True),
    (("between", "i1", 40, 50), False),
    (("in", "i1", (7, 99)), False),
    (("in", "i1", (7, 32)), True),
    (("isnull", "f1"), True),
    (("unknown-shape", "x"), True),
    (("and", ("cmp", "i1", ">", 100), ("cmp", "f1", ">", 0)), False),
    (("or", ("cmp", "i1", ">", 100), ("cmp", "f1", ">", 0)), True),
    (("cmp", "nope", "=", 1), True),
    ((), True),
])
def test_zone_map_evaluator_is_conservative(pred, want):
    """The JAX package's hand cases: i1 in [30, 36), f1 in [3, 9)."""
    zones = PSeg.zone_maps(P.Table.from_dict({"f1": np.arange(6.0) + 3, "i1": np.arange(6) + 30}))
    assert PSeg.segment_may_match(zones, pred) is want
    assert JSeg.segment_may_match(zones, pred) is want


def test_negative_polarity_never_prunes_a_segment_with_nulls():
    zones = PSeg.zone_maps(P.Table.from_dict({"f1": np.array([1.0, np.nan])}))
    for pred in (("cmp", "f1", "!=", 1.0), ("notin", "f1", (1.0,)),
                 ("not", ("cmp", "f1", "<", 0.0)), ("not", ("between", "f1", 0.0, 2.0))):
        assert PSeg.segment_may_match(zones, pred)


def test_names_match_the_reference():
    assert PSeg.segment_name(3, 17) == JSeg.segment_name(3, 17) == "seg-0000000003-0000000017.parquet"
    assert PSeg.manifest_name("seg-1-2.parquet") == JSeg.manifest_name("seg-1-2.parquet")
    assert PSeg.SEGMENT_DIR == JSeg.SEGMENT_DIR


def test_write_read_round_trip_across_packages(tmp_path):
    """A segment the port writes reads back equal in both packages, and its
    manifest is the JAX package's for the same rows (the Parquet bytes,
    and so the CRC record, included)."""
    cols = _rows()
    batches = [{"batch_id": 4, "rows": 5}, {"batch_id": 5, "rows": 7}]
    pm = PSeg.write_segment(str(tmp_path / "p"), 4, 5, P.Table.from_dict(cols), batches)
    jm = JSeg.write_segment(str(tmp_path / "j"), 4, 5, J.Table.from_dict(cols), batches)
    assert pm == jm
    assert PSeg.load_manifest(str(tmp_path / "p"), pm["file"]) == pm
    rec = pm["data"]
    got = P.Table.from_arrow(PSeg.read_segment(str(tmp_path / "p"), pm["file"], rec))
    _bit_identical(got, P.Table.from_dict(cols))
    from_jax = P.Table.from_arrow(PSeg.read_segment(str(tmp_path / "j"), jm["file"], rec))
    _bit_identical(from_jax, got)
    _bit_identical(J.Table.from_arrow(JSeg.read_segment(str(tmp_path / "p"), pm["file"], rec)),
                   got)
    # no staging temp is left behind
    assert sorted(os.listdir(tmp_path / "p")) == [PSeg.manifest_name(pm["file"]), pm["file"]]


@pytest.mark.parametrize("damage", ["flip", "truncate", "missing"])
def test_damaged_segment_raises_segment_corrupt_error(tmp_path, damage):
    m = PSeg.write_segment(str(tmp_path), 0, 1, P.Table.from_dict(_rows()),
                           [{"batch_id": 0, "rows": 6}, {"batch_id": 1, "rows": 6}])
    path = tmp_path / m["file"]
    blob = bytearray(path.read_bytes())
    if damage == "flip":
        blob[len(blob) // 2] ^= 0x01
        path.write_bytes(bytes(blob))
    elif damage == "truncate":
        path.write_bytes(bytes(blob[:-3]))
    else:
        path.unlink()
    with pytest.raises(PSeg.SegmentCorruptError, match=m["file"]):
        PSeg.read_segment(str(tmp_path), m["file"], m["data"])
    with pytest.raises(JSeg.SegmentCorruptError):
        JSeg.read_segment(str(tmp_path), m["file"], m["data"])


def test_quarantine_moves_data_and_manifest_aside(tmp_path):
    m = PSeg.write_segment(str(tmp_path), 0, 0, P.Table.from_dict(_rows()),
                           [{"batch_id": 0, "rows": 12}])
    dst = PSeg.quarantine_segment(str(tmp_path), m["file"])
    assert dst == str(tmp_path / (m["file"] + ".quarantine"))
    names = sorted(os.listdir(tmp_path))
    assert names == sorted([m["file"] + ".quarantine",
                            PSeg.manifest_name(m["file"]) + ".quarantine"])
    # a second pass (a resumed kill) is a no-op, and readers see nothing
    PSeg.quarantine_segment(str(tmp_path), m["file"])
    assert sorted(os.listdir(tmp_path)) == names
    assert PSeg.load_manifest(str(tmp_path), m["file"]) is None
    with pytest.raises(PSeg.SegmentCorruptError, match="unreadable"):
        PSeg.read_segment(str(tmp_path), m["file"], m["data"])


def test_unparseable_manifest_reads_as_none(tmp_path):
    (tmp_path / "seg-x.json").write_text("{not json")
    assert PSeg.load_manifest(str(tmp_path), "seg-x.parquet") is None
    assert PSeg.load_manifest(str(tmp_path), "seg-y.parquet") is None


def test_enospc_at_stage_is_a_short_write_never_published(tmp_path):
    plan = faults.FaultPlan().disk_full("table.seal.stage", after_bytes=10)
    with faults.active(plan):
        with pytest.raises(OSError) as ei:
            PSeg.write_segment(str(tmp_path), 0, 0, P.Table.from_dict(_rows()),
                               [{"batch_id": 0, "rows": 12}])
    assert ei.value.errno == errno.ENOSPC
    assert plan.fired("table.seal.stage") == 1
    name = PSeg.segment_name(0, 0)
    assert not (tmp_path / name).exists()
    assert (tmp_path / (name + ".tmp")).stat().st_size == 10


def test_stage_kill_leaves_nothing_published(tmp_path):
    plan = faults.FaultPlan().crash("table.seal.stage")
    with faults.active(plan):
        with pytest.raises(faults.InjectedCrash):
            PSeg.write_segment(str(tmp_path), 0, 0, P.Table.from_dict(_rows()),
                               [{"batch_id": 0, "rows": 12}])
    assert os.listdir(tmp_path) == []


def test_segments_need_pyarrow_and_name_the_extra(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    with pytest.raises(ImportError, match="'parquet' extra"):
        PSeg.write_segment(str(tmp_path), 0, 0, P.Table.from_dict(_rows()),
                           [{"batch_id": 0, "rows": 12}])


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, (1 << 18) - 1, 1 << 18, 300_007,
                               (1 << 24) + 5])
def test_the_numpy_crc32c_gives_the_reference_digests(n, monkeypatch):
    """``crc32c_lanes`` (what segment scans use where google-crc32c is
    missing, as on the card's host) against the JAX package's digest, with
    and without a chained start value; below 1 MB against the pure loop
    too."""
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu.io import integrity as JI
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.io import integrity as PI

    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    for value in (0, 0xDEADBEEF):
        want = JI.crc32c(data, value)
        assert PI.crc32c_lanes(data, value) == want
        if n < 1 << 20:
            assert PI.crc32c_pure(data, value) == want
    monkeypatch.setattr(PI, "_gcrc", None)
    assert PI.crc32c(data) == JI.crc32c(data)
    assert PI.crc32c_hex(data) == JI.crc32c_hex(data)

"""The port's ``Table`` methods and ``Schema.numeric_names`` against the
JAX package's, on the CPU: the cases of JAX ``tests/test_core.py`` run
through both packages on the same tables.

Every method here is host numpy code copied from the reference, so
everything is compared ``==`` (the sample is the same ``default_rng``
draw, the describe statistics the same float64 numpy calls, ``show`` the
same text); ``to_device`` is the one device entry point, compared by its
padded rows.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.config import (
    MeshConfig as JMeshConfig,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import parallel as P

torch.set_num_threads(1)

PKGS = {"port": port, "jax": J}


def _tables(data):
    return {k: pkg.Table.from_dict(data) for k, pkg in PKGS.items()}


def _same_table(a, b) -> None:
    assert a.schema.names == b.schema.names
    assert [f.dtype for f in a.schema] == [f.dtype for f in b.schema]
    for n in a.schema.names:
        x, y = a.column(n), b.column(n)
        if x.dtype.kind == "f":
            np.testing.assert_array_equal(x, y)
        else:
            assert list(x) == list(y)


def _events(n=400, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "hospital_id": np.array([f"H{i % 5:02d}" for i in range(n)], dtype=object),
        "event_time": np.datetime64("2025-03-31T22:00:00") + np.arange(n).astype(
            "timedelta64[s]"),
        "admission_count": rng.integers(0, 50, n),
        "current_occupancy": rng.integers(20, 400, n),
        "emergency_visits": rng.integers(0, 30, n),
        "seasonality_index": rng.uniform(0.5, 1.5, n),
        "length_of_stay": rng.normal(4.0, 1.0, n),
    }


def test_schema_numeric_names():
    for pkg in PKGS.values():
        assert pkg.hospital_event_schema().numeric_names() == [
            "admission_count", "current_occupancy", "emergency_visits",
            "seasonality_index", "length_of_stay"]
    t = _tables({"h": np.array(["a"], object), "v": [1.0], "t": np.array(
        ["2025-01-01"], dtype="datetime64[ns]"), "i": np.array([3])})
    assert t["port"].schema.numeric_names() == t["jax"].schema.numeric_names() == ["v", "i"]


def test_describe_spark_semantics():
    t = _tables({"h": np.array(["a", "b", "c"], object), "v": np.array([1.5, np.nan, 3.0]),
                 "w": np.array([2.0, 4.0, 6.0])})
    d = t["port"].describe()
    _same_table(d, t["jax"].describe())
    assert list(d.column("summary")) == ["count", "mean", "stddev", "min", "max"]
    np.testing.assert_allclose(d.column("v"), [2, 2.25, np.std([1.5, 3.0], ddof=1), 1.5, 3.0])
    d2 = t["port"].describe("w")
    assert set(d2.columns) == {"summary", "w"}
    _same_table(d2, t["jax"].describe("w"))
    with pytest.raises(TypeError, match="not numeric"):
        t["port"].describe("h")
    with pytest.raises(ValueError, match="reserves the output column"):
        port.Table.from_dict({"summary": np.array([1.0, 2.0])}).describe()
    # a single row: stddev NaN; an all-NaN column: count 0
    one = _tables({"v": np.array([2.0]), "n": np.array([np.nan])})
    _same_table(one["port"].describe(), one["jax"].describe())


@pytest.mark.parametrize("n,truncate", [(3, 20), (20, 0), (1, 2)])
def test_show_prints_the_reference_text(n, truncate, capsys):
    data = {"x": np.arange(30).astype(np.float64) / 7,
            "s": np.array(["abcdefghij" * (i % 3) for i in range(30)], object),
            "ts": np.array(["NaT"] + ["2025-03-31T10:00:00"] * 29, dtype="datetime64[ns]")}
    t = _tables(data)
    t["jax"].show(n, truncate)
    want = capsys.readouterr().out
    t["port"].show(n, truncate)
    got = capsys.readouterr().out
    assert got == want
    if n < 30:
        assert f"only showing top {n} rows" in got


def test_show_edge_cases(capsys):
    t = port.Table.from_dict({"s": np.array(["abcdefghij"], object),
                              "ts": np.array(["NaT"], dtype="datetime64[ns]")})
    t.show(truncate=2)
    out = capsys.readouterr().out
    assert "ab " in out and "abcdefghi" not in out  # hard cut, no ellipsis
    assert "NULL" in out and "NaT" not in out       # NaT renders as NULL


def test_sample_drop_rename():
    data = {"a": np.arange(1000).astype(np.float64), "b": np.ones(1000)}
    t = _tables(data)
    s = t["port"].sample(0.3, seed=1)
    assert 200 < len(s) < 400
    _same_table(s, t["jax"].sample(0.3, seed=1))
    _same_table(t["port"].sample(0.0), t["jax"].sample(0.0))
    with pytest.raises(ValueError, match="fraction"):
        t["port"].sample(1.5)
    r = t["port"].with_column_renamed("a", "alpha")
    _same_table(r, t["jax"].with_column_renamed("a", "alpha"))
    assert r.schema.field("alpha").dtype == t["port"].schema.field("a").dtype
    assert t["port"].with_column_renamed("zzz", "x") is t["port"]
    assert t["port"].with_column_renamed("a", "a").columns.keys() == {"a", "b"}
    with pytest.raises(ValueError, match="already exists"):
        t["port"].with_column_renamed("a", "b")


def test_filter_sort_by_group_count():
    t = _tables(_events())
    f = {k: v.filter(lambda tb: tb["length_of_stay"] > 4.0) for k, v in t.items()}
    _same_table(f["port"], f["jax"])
    assert f["port"].num_rows == int((t["port"]["length_of_stay"] > 4.0).sum())
    for col in ("length_of_stay", "hospital_id", "admission_count"):
        _same_table(t["port"].sort_by(col), t["jax"].sort_by(col))
    for col in ("hospital_id", "admission_count"):
        assert t["port"].group_count(col) == t["jax"].group_count(col)
    assert t["port"].group_count("hospital_id") == {f"H{i:02d}": 80 for i in range(5)}


def test_pandas_round_trip():
    t = _tables(_events(50))
    df = t["port"].to_pandas()
    assert isinstance(df, pd.DataFrame) and list(df.columns) == t["port"].schema.names
    pd.testing.assert_frame_equal(df, t["jax"].to_pandas())
    back = port.Table.from_pandas(df)
    _same_table(back, J.Table.from_pandas(t["jax"].to_pandas()))
    _same_table(port.Table.from_pandas(df, port.hospital_event_schema()), t["port"])


@pytest.mark.parametrize("shape", [(1, 1), (8, 1), (4, 2)])
def test_to_device_over_a_mesh(shape):
    t = _tables(_events(101))
    feats = ["admission_count", "current_occupancy", "seasonality_index"]
    mesh = P.build_mesh(port.MeshConfig(data=shape[0], model=shape[1]),
                        [torch.device("cpu")] * 8)
    ds = t["port"].to_device(feats, "length_of_stay", mesh=mesh)
    jds = t["jax"].to_device(feats, "length_of_stay",
                             mesh=J.parallel.build_mesh(JMeshConfig(data=shape[0],
                                                                    model=shape[1])))
    assert isinstance(ds, P.ShardedDataset if shape != (1, 1) else port.DeviceDataset)
    assert ds.n_padded == jds.n_padded
    for a in ("x", "y", "w"):
        got = P.unpad(getattr(ds, a), ds.n_padded)
        np.testing.assert_array_equal(got, np.asarray(getattr(jds, a)))
    one = t["port"].to_device(feats, device="cpu")
    np.testing.assert_array_equal(one.x.numpy(), np.asarray(jds.x)[:101])

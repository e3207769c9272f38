"""The port's CSV engines against the JAX package's, on the CPU.

Each port engine (``native``, ``arrow``, ``numpy``) is held to the JAX
engine of the same name, and the port's ``auto`` to the JAX package's
``auto`` (native → arrow → numpy), on the bundled CSV, four generated
drops, the inputs on which the engines disagree with each other, and edge
inputs.  Every comparison is exact: same columns, same dtypes, same values
(NaN and NaT compare equal to themselves).  Where the JAX engine raises,
the port's must raise the same exception type.  The port builds the
native scan from ``native/csv_scan.cpp`` with ``g++`` into its own build
directory; without ``g++`` the native cases skip.

Also here: the source's native directory listing against the JAX
package's, the per-engine file counts, the vectorized string decode
against the per-cell one (and a long cell taking the per-cell decode), and
a failed build being logged.
"""

import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from clustermachinelearningforhospitalnetworks_apache_spark_tpu.core.schema import (
    Field as JField,
    Schema as JSchema,
    hospital_event_schema as jax_schema,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.io import csv as jcsv
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.io import native as jnative
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.streaming.source import (
    FileStreamSource as JaxSource,
)
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.core.schema import (
    Field,
    Schema,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.io import csv as pcsv
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.io import native as pnative
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parents[1]
BUNDLED = REPO / "data" / "hospital_patients.csv"
ENGINES = ("auto", "native", "arrow", "numpy")

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="g++ not found: the native scan cannot be built")

# schema of the small cases: string, timestamp, float, int
SMALL = (("s", "string"), ("t", "timestamp"), ("f", "float"), ("i", "int"))
HEAD = "s,t,f,i\n"

# inputs on which the native and numpy engines disagree (one row each)
DIVERGENT = {
    "quoted_comma": HEAD + '"H,1",2025-03-31 22:00:00,1.5,2\n',
    "underscore": HEAD + "H1,2025-03-31 22:00:00,1_000,2\n",
    "hex": HEAD + "H1,2025-03-31 22:00:00,0x10,2\n",
}

EDGE = {
    "empty_cells": HEAD + "H1,,,\n,2025-03-31 22:00:00,1.0,\n",
    "spaces": HEAD + "H1, 2025-03-31 22:00:00 , 1.5 , 2 \n",
    "nan_inf": HEAD + "H1,2025-03-31 22:00:00,nan,inf\nH2,2025-03-31 22:00:01,-inf,NaN\n",
    "short_row": HEAD + "H1,2025-03-31 22:00:00\nH2,2025-03-31 22:00:01,2.0,3\n",
    "long_row": HEAD + "H1,2025-03-31 22:00:00,1.0,2,extra\n",
    "blank_lines": HEAD + "\nH1,2025-03-31 22:00:00,1.0,2\n\n\nH2,2025-03-31 22:00:01,2.0,3\n",
    "crlf": HEAD.replace("\n", "\r\n") + "H1,2025-03-31 22:00:00,1.0,2\r\n",
    "date_only": HEAD + "H1,2025-03-31,1.0,2\n",
    "t_timestamp": HEAD + "H1,2025-03-31T22:00:00,1.0,2\n",
    "fraction_seconds": HEAD + "H1,2025-03-31 22:00:00.250,1.0,2\n",
    "bad_number": HEAD + "H1,2025-03-31 22:00:00,abc,2\n",
    "leading_zeros": HEAD + "007,2025-03-31 22:00:00,1.0,2\n",
    "header_only": HEAD,
    "no_trailing_newline": HEAD + "H1,2025-03-31 22:00:00,1.0,2",
}


def _rows_with(n: int, at: int, cell: str) -> str:
    rows = [f"H{i % 7},2025-03-31 22:00:{i % 60:02d},{i}.5,{i}\n" for i in range(n)]
    rows[at] = cell + rows[at][rows[at].index(","):]
    return HEAD + "".join(rows)


# one cell far longer than the rest: the vectorized string decode would
# gather rows x the longest cell; an unterminated quote near the end of a
# drop swallows the remaining lines into one such cell
LONG_CELLS = {
    "long_cell": _rows_with(1000, 500, '"' + "x" * 20_000 + '"'),
    "unterminated_quote": _rows_with(1000, 900, '"H900'),
}


def _schemas():
    return (Schema([Field(n, t) for n, t in SMALL]),
            JSchema([JField(n, t) for n, t in SMALL]))


def _same_value(a, b) -> bool:
    if type(a) is not type(b):
        return False
    if isinstance(a, (float, np.floating)) and np.isnan(a):
        return bool(np.isnan(b))
    if isinstance(a, np.datetime64) and np.isnat(a):
        return bool(np.isnat(b))
    return bool(a == b)


def assert_tables_equal(pt, jt):
    assert pt.schema.names == jt.schema.names
    assert pt.num_rows == jt.num_rows
    for c in jt.schema.names:
        p, j = pt[c], jt[c]
        assert p.dtype == j.dtype, c
        if p.dtype == object:
            bad = [i for i, (a, b) in enumerate(zip(p, j)) if not _same_value(a, b)]
            assert bad == [], (c, bad[:5], p[bad[:5]], j[bad[:5]])
        else:
            np.testing.assert_array_equal(p, j, err_msg=c)


def assert_engine_parity(path, engine, schemas):
    ps, js = schemas
    if engine in ("auto", "native") and not (jnative.native_available()
                                             and pnative.native_available()):
        pytest.skip("a native CSV library did not build (see the log)")
    try:
        jt = jcsv.read_csv(str(path), js, engine=engine)
    except Exception as e:      # the JAX engine raises: the port must, alike
        with pytest.raises(type(e)):
            port.read_csv(str(path), ps, engine=engine)
        return None
    pt = port.read_csv(str(path), ps, engine=engine)
    assert_tables_equal(pt, jt)
    return pt


def _engine_param(e):
    return pytest.param(e, marks=needs_gxx) if e in ("auto", "native") else e


ENGINE_PARAMS = [_engine_param(e) for e in ENGINES]


@pytest.mark.parametrize("engine", ENGINE_PARAMS)
def test_bundled_csv(engine):
    pt = assert_engine_parity(BUNDLED, engine, (port.hospital_event_schema(), jax_schema()))
    assert pt is not None and pt.num_rows == 20_000


def _drop(path, seed, n):
    rng = np.random.default_rng(seed)
    t0 = np.datetime64("2025-03-31T21:00:00", "ns")
    cols = {
        "hospital_id": np.array([f"H{h:02d}" for h in rng.integers(0, 12, n)], dtype=object),
        "event_time": t0 + rng.integers(0, 3 * 3600, n).astype("timedelta64[s]"),
        "admission_count": rng.integers(0, 40, n).astype(np.float64),
        "current_occupancy": rng.integers(50, 500, n).astype(np.float64),
        "emergency_visits": rng.integers(0, 20, n).astype(np.float64),
        "seasonality_index": rng.uniform(0.5, 1.5, n),
        "length_of_stay": np.round(rng.gamma(2.0, 2.0, n), seed % 4),
    }
    port.write_csv(port.Table.from_dict(cols, port.hospital_event_schema()), str(path))


@pytest.mark.parametrize("engine", ENGINE_PARAMS)
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_generated_drops(engine, seed, tmp_path):
    path = tmp_path / f"drop{seed}.csv"
    _drop(path, seed, 300 + 97 * seed)
    assert assert_engine_parity(path, engine, (port.hospital_event_schema(), jax_schema()))


@pytest.mark.parametrize("engine", ENGINE_PARAMS)
@pytest.mark.parametrize("case", sorted(DIVERGENT))
def test_inputs_where_the_engines_disagree(engine, case, tmp_path):
    path = tmp_path / f"{case}.csv"
    path.write_text(DIVERGENT[case])
    assert_engine_parity(path, engine, _schemas())


@needs_gxx
def test_auto_takes_the_native_engine_like_jax(tmp_path):
    """The fault this closes: the port's ``auto`` used to mean numpy, the
    JAX package's means native, and the two read these inputs apart."""
    ps, _ = _schemas()
    for case, want in (("quoted_comma", ("s", "H,1")), ("underscore", ("f", np.float64("nan"))),
                       ("hex", ("f", np.float64(16.0)))):
        path = tmp_path / f"{case}.csv"
        path.write_text(DIVERGENT[case])
        pcsv.reset_engine_counts()
        got = port.read_csv(str(path), ps)[want[0]][0]
        assert _same_value(got, want[1]), (case, got)
        assert pcsv.engine_counts() == {"native": 1, "arrow": 0, "numpy": 0}
    with pytest.raises(ValueError):          # numpy cannot read the quoted comma
        port.read_csv(str(tmp_path / "quoted_comma.csv"), ps, engine="numpy")


@pytest.mark.parametrize("engine", ENGINE_PARAMS)
@pytest.mark.parametrize("case", sorted(EDGE))
def test_edge_inputs(engine, case, tmp_path):
    path = tmp_path / f"{case}.csv"
    path.write_bytes(EDGE[case].encode())
    assert_engine_parity(path, engine, _schemas())


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="unknown CSV engine"):
        port.read_csv(str(BUNDLED), port.hospital_event_schema(), engine="pandas")


def test_engine_counts_count_files(tmp_path):
    pcsv.reset_engine_counts()
    for e in ("arrow", "numpy", "numpy"):
        port.read_csv(str(BUNDLED), port.hospital_event_schema(), engine=e)
    assert pcsv.engine_counts() == {"native": 0, "arrow": 1, "numpy": 2}
    pcsv.reset_engine_counts()
    assert pcsv.engine_counts() == {"native": 0, "arrow": 0, "numpy": 0}


@needs_gxx
def test_library_is_built_from_the_shared_source_into_the_build_dir():
    assert pnative.native_available()
    lib = _build.host_library_path("csv_scan")
    assert lib.exists() and lib.parent == _build.build_dir()
    assert _build.HOST_SOURCES["csv_scan"] == REPO / "native" / "csv_scan.cpp"
    # hashed on the source and the flags, as the CUDA libraries are
    assert lib.name.startswith("libcsv_scan-") and lib.name != "libcsv_scan.so"


@needs_gxx
@pytest.mark.parametrize("cells", [
    ["H01", "H02", ""], ["", "", ""], ["é", "日本", "a\"b"], ["x" * 40, "y", ""],
    ["bad\xff", "ok", "trail\x00"],
])
def test_vectorized_string_decode_equals_per_cell(cells):
    raw = [c.encode("latin-1") if "\xff" in c or "\x00" in c else c.encode() for c in cells]
    buf = np.frombuffer(b"".join(raw) or b"\0", dtype=np.uint8)
    offsets = np.concatenate([[0], np.cumsum([len(r) for r in raw])]).astype(np.int64)
    for n_str in (1, len(cells)):
        rows = len(cells) // n_str
        a = pnative.string_columns_per_cell(buf, offsets, rows, n_str)
        b = pnative.string_columns(buf, offsets, rows, n_str)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype == object
            assert list(x) == list(y) and all(type(v) is str for v in y)


@pytest.mark.parametrize("engine", ENGINE_PARAMS)
@pytest.mark.parametrize("case", sorted(LONG_CELLS))
def test_long_cells(engine, case, tmp_path):
    path = tmp_path / f"{case}.csv"
    path.write_text(LONG_CELLS[case])
    assert_engine_parity(path, engine, _schemas())


@needs_gxx
@pytest.mark.parametrize("case", sorted(LONG_CELLS))
def test_a_long_cell_takes_the_per_cell_decode(case, tmp_path, monkeypatch):
    """The fixed-width gather would be rows x the longest cell; past a few
    times the cells' bytes the decode goes cell by cell instead."""
    path = tmp_path / f"{case}.csv"
    path.write_text(LONG_CELLS[case])
    per_cell = pnative.string_columns_per_cell
    calls = []
    monkeypatch.setattr(pnative, "string_columns_per_cell",
                        lambda *a: calls.append(a[2]) or per_cell(*a))
    t = port.read_csv(str(path), _schemas()[0], engine="native")
    assert calls == [t.num_rows] and t.num_rows > 500
    assert max(len(v) for v in t["s"]) > 3000


@needs_gxx
def test_native_dir_listing_equals_jax(tmp_path):
    names = ["b.csv", "a.csv", "c.csv", "notes.txt", "tab\tname.csv"]
    for i, n in enumerate(names):
        p = tmp_path / n
        p.write_text(HEAD)
        os.utime(p, ns=(1_700_000_000_000_000_000 + (i % 2) * 10**9,) * 2)
    (tmp_path / "dir.csv").mkdir()
    if not jnative.native_available():
        pytest.skip("the JAX package's native library did not build")
    assert sorted(pnative.native_dir_list(str(tmp_path))) == sorted(
        jnative.native_dir_list(str(tmp_path)))
    ps, js = _schemas()
    want = JaxSource(str(tmp_path), js).list_files()
    got = port.FileStreamSource(str(tmp_path), ps).list_files()
    assert got == want and len(got) == 4


def test_listing_without_the_library_sorts_the_same(tmp_path, monkeypatch):
    for i, n in enumerate(["b.csv", "a.csv", "c.csv"]):
        p = tmp_path / n
        p.write_text(HEAD)
        os.utime(p, ns=(10**18,) * 2)
    ps, js = _schemas()
    want = JaxSource(str(tmp_path), js).list_files()
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.streaming import (
        source,
    )
    monkeypatch.setattr(source, "native_available", lambda: False)
    assert port.FileStreamSource(str(tmp_path), ps).list_files() == want


@needs_gxx
def test_a_name_that_is_not_utf8_is_listed_as_jax_lists_it(tmp_path, monkeypatch):
    """The two listings differ on such a name (the native one decodes it
    with U+FFFD), so the source keeps the native one where JAX has it."""
    if not jnative.native_available():
        pytest.skip("the JAX package's native library did not build")
    (tmp_path / "a.csv").write_text(HEAD)
    with open(os.path.join(os.fsencode(tmp_path), b"h\xf4pital.csv"), "wb") as f:
        f.write(HEAD.encode())
    ps, js = _schemas()
    want = JaxSource(str(tmp_path), js).list_files()
    assert port.FileStreamSource(str(tmp_path), ps).list_files() == want
    assert any("\ufffd" in f for f in want)
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.streaming import (
        source,
    )
    monkeypatch.setattr(source, "native_available", lambda: False)
    assert sorted(port.FileStreamSource(str(tmp_path), ps).list_files()) != sorted(want)


def test_failed_build_is_logged_and_auto_falls_to_arrow(tmp_path, monkeypatch):
    import io

    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import (
        logging as plog,
    )

    logged = io.StringIO()
    monkeypatch.setattr(plog._CONFIG, "stream", logged)
    bad = tmp_path / "csv_scan.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setenv("CMLHN_TORCH_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setitem(_build.HOST_SOURCES, "csv_scan", bad)
    monkeypatch.setattr(pnative, "_TRIED", False)
    monkeypatch.setattr(pnative, "_LIB", None)
    assert not pnative.native_available()
    err = logged.getvalue()
    assert "native CSV engine unavailable" in err
    if shutil.which("g++"):
        assert "g++ failed" in err
    pcsv.reset_engine_counts()
    port.read_csv(str(BUNDLED), port.hospital_event_schema())
    assert pcsv.engine_counts() == {"native": 0, "arrow": 1, "numpy": 0}

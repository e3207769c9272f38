"""ctypes binding of the native C++ CSV scan and directory listing (the
JAX package's ``io/native.py``).

Both packages parse with one source, ``native/csv_scan.cpp`` at the root
of the repository, so they read every file identically by construction.
The port compiles it with ``g++`` at first use into its own build
directory (``ops/_build.py``: ``build_host``, named by a hash of the
source and the flags); it never runs ``make`` and never loads the JAX
package's ``native/libcsv_scan.so``.  A failed build is logged with the
compiler's output and leaves the engine unavailable, so ``read_csv``'s
``auto`` goes on to the Arrow engine as the JAX package's does.
``CMLHN_NO_NATIVE_BUILD`` set skips the build (a library built before
still loads).

The boundary is a plain C ABI: numeric cells cross as a float64 matrix,
timestamps as int64 nanoseconds, strings as one concatenated byte buffer
plus a prefix-offsets array.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Tuple

import numpy as np

from ..ops import _build
from ..utils.logging import get_logger

log = get_logger("io.native")

_LIB = None
_TRIED = False
_LOAD_LOCK = threading.Lock()

_KIND_NUM, _KIND_TS, _KIND_STR = 0, 1, 2


def _load():
    global _LIB, _TRIED
    with _LOAD_LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _build.host_library_path("csv_scan") if _build.HOST_SOURCES[
            "csv_scan"].is_file() else None
        try:
            if path is None or (not path.exists() and os.environ.get("CMLHN_NO_NATIVE_BUILD")):
                raise RuntimeError("the native CSV scan is not built (CMLHN_NO_NATIVE_BUILD "
                                   "is set, or native/csv_scan.cpp is missing)")
            _LIB = _bind(str(_build.build_host("csv_scan")))
        except (RuntimeError, OSError, AttributeError) as e:
            log.warning("native CSV engine unavailable", error=str(e))
            _LIB = None
        return _LIB


def _bind(path: str):
    """CDLL + symbol signatures; raises AttributeError on a stale library."""
    lib = ctypes.CDLL(path)
    lib.csv_count_rows.restype = ctypes.c_long
    lib.csv_count_rows.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.csv_parse_numeric.restype = ctypes.c_long
    lib.csv_parse_numeric.argtypes = [
        ctypes.c_char_p,                  # path
        ctypes.c_int,                     # header (0/1)
        ctypes.c_int,                     # ncols
        ctypes.POINTER(ctypes.c_int),     # numeric column indices
        ctypes.c_int,                     # n numeric
        ctypes.POINTER(ctypes.c_double),  # out buffer (rows*n_numeric)
        ctypes.c_long,                    # capacity rows
    ]
    lib.csv_parse_table.restype = ctypes.c_long
    lib.csv_parse_table.argtypes = [
        ctypes.c_char_p,                  # path
        ctypes.c_int,                     # header
        ctypes.c_int,                     # ncols
        ctypes.POINTER(ctypes.c_int),     # kinds per column
        ctypes.POINTER(ctypes.c_double),  # out numeric
        ctypes.POINTER(ctypes.c_int64),   # out timestamps (ns)
        ctypes.c_char_p,                  # out string bytes
        ctypes.POINTER(ctypes.c_int64),   # string prefix offsets
        ctypes.c_long,                    # capacity rows
        ctypes.c_int64,                   # capacity string bytes
    ]
    lib.csv_size.restype = ctypes.c_long
    lib.csv_size.argtypes = [
        ctypes.c_char_p,                  # path
        ctypes.c_int,                     # header
        ctypes.c_int,                     # ncols
        ctypes.POINTER(ctypes.c_int),     # kinds (nullable)
        ctypes.POINTER(ctypes.c_int64),   # out string bytes (nullable)
    ]
    lib.dir_list.restype = ctypes.c_long
    lib.dir_list.argtypes = [
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_char_p,
        ctypes.c_long,
    ]
    return lib


def native_available() -> bool:
    return _load() is not None


def native_count_rows(path: str, header: bool = True) -> int:
    lib = _load()
    n = int(lib.csv_count_rows(path.encode(), 1 if header else 0))
    if n < 0:
        raise OSError(f"csv_count_rows({path}) failed: {n}")
    return n


def native_parse_numeric(
    path: str, col_indices: List[int], ncols: int, header: bool = True
) -> np.ndarray:
    """Parse the given numeric columns of a CSV into a float64 matrix."""
    lib = _load()
    nrows = native_count_rows(path, header)
    k = len(col_indices)
    out = np.empty((max(nrows, 1), k), dtype=np.float64)
    idx = (ctypes.c_int * k)(*col_indices)
    got = lib.csv_parse_numeric(
        path.encode(),
        1 if header else 0,
        ncols,
        idx,
        k,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        nrows,
    )
    if got < 0:
        raise OSError(f"csv_parse_numeric({path}) failed: {got}")
    return out[: int(got)]


def native_scan(path: str, kinds: List[int], header: bool = True):
    """The C scan alone: → ``(numeric (rows, n_num) f64, ts (rows, n_ts)
    i64-ns, string bytes, string prefix offsets (rows·n_str + 1,), rows)``.
    Cell ``i`` of the row-major string cells is
    ``bytes[offsets[i]:offsets[i + 1]]``."""
    lib = _load()
    ncols = len(kinds)
    n_num = sum(1 for k in kinds if k == _KIND_NUM)
    n_ts = sum(1 for k in kinds if k == _KIND_TS)
    n_str = sum(1 for k in kinds if k == _KIND_STR)
    kinds_c = (ctypes.c_int * ncols)(*kinds)

    # One sizing pass yields both the row count and the exact string-byte
    # total, so the whole read is two passes over the file.
    str_bytes = ctypes.c_int64(0)
    nrows = int(
        lib.csv_size(
            path.encode(),
            1 if header else 0,
            ncols,
            kinds_c if n_str else None,
            ctypes.byref(str_bytes) if n_str else None,
        )
    )
    if nrows < 0:
        raise OSError(f"csv_size({path}) failed: {nrows}")
    cap_bytes = int(str_bytes.value)

    cap_rows = max(nrows, 1)
    out_num = np.empty((cap_rows, max(n_num, 1)), dtype=np.float64)
    out_ts = np.empty((cap_rows, max(n_ts, 1)), dtype=np.int64)
    out_str = np.empty((max(cap_bytes, 1),), dtype=np.uint8)
    offsets = np.zeros((cap_rows * max(n_str, 1) + 1,), dtype=np.int64)

    got = lib.csv_parse_table(
        path.encode(),
        1 if header else 0,
        ncols,
        kinds_c,
        out_num.ctypes.data_as(ctypes.POINTER(ctypes.c_double)) if n_num else None,
        out_ts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)) if n_ts else None,
        out_str.ctypes.data_as(ctypes.c_char_p) if n_str else None,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)) if n_str else None,
        cap_rows,
        cap_bytes,
    )
    if got < 0:
        raise OSError(f"csv_parse_table({path}) failed: {got}")
    rows = int(got)
    return (out_num[:rows, :n_num], out_ts[:rows, :n_ts], out_str,
            offsets[: rows * n_str + 1] if n_str else offsets[:1], rows)


#: the fixed-width gather's largest size, as a multiple of the cells' bytes
_GATHER_MAX_BLOWUP = 4


def string_columns_per_cell(buf: np.ndarray, offsets: np.ndarray, rows: int,
                            n_str: int) -> List[np.ndarray]:
    """The JAX package's decode: one ``bytes.decode`` per cell."""
    raw = buf.tobytes()
    cells = [
        raw[offsets[i] : offsets[i + 1]].decode("utf-8", errors="replace")
        for i in range(rows * n_str)
    ]
    return [np.array(cells[j::n_str], dtype=object) for j in range(n_str)]


def string_columns(buf: np.ndarray, offsets: np.ndarray, rows: int,
                   n_str: int) -> List[np.ndarray]:
    """The string columns with no per-cell Python: every cell's bytes are
    gathered into one fixed-width ``S`` array, decoded by numpy and
    turned into ``str`` objects — the same values as
    :func:`string_columns_per_cell`.  A numpy ``S`` value drops trailing
    NUL bytes, so a file with a cell ending in NUL takes the per-cell
    decode.  So does a file whose longest cell would make the gather more
    than ``_GATHER_MAX_BLOWUP`` times the cells' bytes (one long cell, or an
    unterminated quote swallowing the rest of the file into one cell)."""
    n = rows * n_str
    if n == 0:
        return [np.empty((0,), dtype=object) for _ in range(n_str)]
    starts, ends = offsets[:-1], offsets[1:]
    lens = ends - starts
    width = int(lens.max())
    if width == 0:
        return [np.full((rows,), "", dtype=object) for _ in range(n_str)]
    if n * width > _GATHER_MAX_BLOWUP * max(int(ends[-1] - starts[0]), 1):
        return string_columns_per_cell(buf, offsets, rows, n_str)
    if buf[ends[lens > 0] - 1].min(initial=1) == 0:
        return string_columns_per_cell(buf, offsets, rows, n_str)
    col = np.arange(width, dtype=np.int64)
    inside = col[None, :] < lens[:, None]
    fixed = np.zeros((n, width), dtype=np.uint8)
    fixed[inside] = buf[(starts[:, None] + col[None, :])[inside]]
    cells = fixed.view(f"S{width}").reshape(n)
    if bool((buf[: int(ends[-1])] < 0x80).all()):
        text = cells.astype(f"U{width}")
    else:
        text = np.char.decode(cells, "utf-8", errors="replace")
    text = text.astype(object)
    return [text[j::n_str].copy() for j in range(n_str)]


def native_read_table(
    path: str, kinds: List[int], header: bool = True
) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray], int]:
    """Full typed parse.

    ``kinds[i]`` per CSV column: 0 numeric, 1 timestamp, 2 string.
    Returns ``(numeric (rows, n_num) f64, ts (rows, n_ts) i64-ns,
    string_columns [n_str arrays of object], rows)``.
    """
    num, ts, buf, offsets, rows = native_scan(path, kinds, header)
    n_str = sum(1 for k in kinds if k == _KIND_STR)
    strs = string_columns(buf, offsets, rows, n_str) if n_str else []
    return num, ts, strs, rows


def native_dir_list(path: str, suffix: str = ".csv") -> List[Tuple[int, int, str]]:
    """List files under ``path`` ending in ``suffix`` → [(mtime_ns, size, name)].
    The native counterpart of the streaming file source's os.scandir poll."""
    lib = _load()
    cap = 1 << 16
    while True:
        buf = ctypes.create_string_buffer(cap)
        n = int(lib.dir_list(path.encode(), suffix.encode(), buf, cap))
        if n == -2:
            cap *= 4
            if cap > (1 << 28):
                raise OSError(f"dir_list({path}): listing exceeds {cap} bytes")
            continue
        if n < 0:
            raise OSError(f"dir_list({path}) failed: {n}")
        # Records are NUL-framed (a POSIX filename cannot contain NUL), so
        # names with newlines or tabs cannot corrupt the parse — the name is
        # everything after the second tab.
        out: List[Tuple[int, int, str]] = []
        for rec in buf.raw.split(b"\0"):
            if not rec:
                break  # every record is non-empty; first empty = end of data
            mtime_s, size_s, name = rec.decode("utf-8", errors="replace").split("\t", 2)
            out.append((int(mtime_s), int(size_s), name))
        return out

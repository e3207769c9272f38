"""Sealed columnar segments for the unbounded table's cold history (the
JAX package's ``core/segments.py``: the same file names, manifests, CRC
records and zone maps, so a segment sealed by either package reads in
the other).

A segment is one compacted Parquet file covering a contiguous run of
committed batch ids, plus a JSON manifest carrying the CRC32C record of
the data bytes (``io/integrity.py``) and per-column min/max/null-count
zone maps that the SQL planner uses to prune scans (data skipping).  This
module owns all durable IO for segments — staging, atomic publish,
quarantine; the lifecycle policy that decides what to seal, retire and
scrub lives in :mod:`.table_lifecycle` and never touches bytes directly.

Crash consistency: a segment is invisible until its seal entry lands in
the table's commit log (the single source of truth).  Staging writes
data then manifest, each atomically, under the ``table.seal.stage``
fault site; a kill at any point leaves only orphan ``seg-*`` files that
the next seal pass re-stages under the same name (deterministic naming
by batch-id range).  An injected ``disk_full`` rule surfaces here as a
short write of exactly the bytes that fit into the staging temp file,
then ENOSPC: the temp is never renamed, so committed state is untouched.

Everything here is host work (numpy, pyarrow, CRC32C) and takes no
``device=``.  pyarrow is imported at first use: it is the project's
``parquet`` extra.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..io.integrity import checksum_record, verify_bytes
from ..io.model_io import fsync_dir
from ..utils.faults import enospc_error, enospc_point, fault_point

SEGMENT_DIR = "_segments"


def pyarrow_module():
    """The ``pyarrow`` module, imported at first use: the table's parts
    and segments are Parquet, and pyarrow is the project's ``parquet``
    extra."""
    try:
        import pyarrow as pa
    except ImportError as e:
        raise ImportError(
            "the unbounded table's Parquet parts and sealed segments need "
            "pyarrow: install the project's 'parquet' extra (pip install "
            "'.[parquet]')"
        ) from e
    return pa


class SegmentCorruptError(RuntimeError):
    """A sealed segment's bytes do not match its committed CRC record
    (bitrot, truncation, or a missing file).  Loud and typed — readers
    never serve a wrong answer from a rotten segment."""


def segment_name(first: int, last: int) -> str:
    """Deterministic data-file name for the seal covering batches
    ``first..last`` — re-staging after a crash reproduces the same name,
    which makes the seal protocol idempotent."""
    return f"seg-{first:010d}-{last:010d}.parquet"


def manifest_name(data_file: str) -> str:
    return os.path.splitext(data_file)[0] + ".json"


def _write_bytes_atomic(path: str, data: bytes, site: str | None = None) -> None:
    """tmp → fsync bytes → rename → fsync dir, with the ``disk_full``
    fault surfacing as a short write + ENOSPC on the temp file (which is
    then never renamed: a full disk can strand staging garbage but never
    publish a truncated segment)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        if site is not None:
            fit = enospc_point(site, len(data), path=path)
            if fit is not None:
                f.write(data[:fit])
                f.flush()
                os.fsync(f.fileno())
                raise enospc_error(site, fit)
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path))


def zone_maps(table) -> dict:
    """Per-column ``{"min", "max", "nulls"}`` over a segment's rows, in
    the comparison space the compiled planner bakes literals into
    (timestamps as int ns).  Conservative by construction:

    * datetime: min/max over the raw i8 view including NaT (NaT is
      INT_MIN, which only widens the bounds — a segment is never wrongly
      pruned whatever the NaT comparison semantics); nulls counts NaT.
    * float: min/max over the non-NaN values (all-NaN → None); nulls
      counts NaN.
    * int/uint/bool: plain min/max, nulls 0.
    * strings/objects: skipped (the planner rejects string predicates).
    """
    zones: dict[str, dict] = {}
    for name, v in table.columns.items():
        k = v.dtype.kind
        if k == "M":
            nulls = int(np.isnat(v).sum())
            i8 = v.view("i8")
            lo = int(i8.min()) if v.size else None
            hi = int(i8.max()) if v.size else None
        elif k == "f":
            nulls = int(np.isnan(v).sum())
            vals = v[~np.isnan(v)]
            lo = float(vals.min()) if vals.size else None
            hi = float(vals.max()) if vals.size else None
        elif k in ("i", "u", "b"):
            nulls = 0
            lo = int(v.min()) if v.size else None
            hi = int(v.max()) if v.size else None
        else:
            continue
        zones[name] = {"min": lo, "max": hi, "nulls": nulls}
    return zones


def write_segment(seg_dir: str, first: int, last: int, table, batches: list[dict]) -> dict:
    """Stage one sealed segment (data + manifest, each atomic) and return
    the manifest.  Nothing here is committed: the caller appends the seal
    entry to the commit log after this returns, so a crash at any byte of
    staging is invisible to readers.

    ``batches`` is the ordered ``[{"batch_id", "rows"}, ...]`` the
    segment folds — the manifest records it so readers can slice single
    batches back out and the scrubber knows which parts rebuild it.
    """
    pa = pyarrow_module()
    import pyarrow.parquet as pq

    os.makedirs(seg_dir, exist_ok=True)
    fname = segment_name(first, last)
    fault_point("table.seal.stage", path=os.path.join(seg_dir, fname))
    sink = pa.BufferOutputStream()
    pq.write_table(table.to_arrow(), sink)
    data = sink.getvalue().to_pybytes()
    manifest = {
        "first": int(first),
        "last": int(last),
        "file": fname,
        "rows": int(len(table)),
        "batches": [
            {"batch_id": int(b["batch_id"]), "rows": int(b["rows"])} for b in batches
        ],
        "data": checksum_record(data),
        "zones": zone_maps(table),
    }
    _write_bytes_atomic(os.path.join(seg_dir, fname), data, site="table.seal.stage")
    _write_bytes_atomic(
        os.path.join(seg_dir, manifest_name(fname)),
        (json.dumps(manifest) + "\n").encode(),
        site="table.seal.stage",
    )
    return manifest


def load_manifest(seg_dir: str, data_file: str) -> dict | None:
    """Manifest for a segment, or None when missing/unparseable — zone
    pruning degrades to a full scan rather than failing the query (the
    commit log's CRC record, not the manifest, is what scrub trusts)."""
    path = os.path.join(seg_dir, manifest_name(data_file))
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def read_segment(seg_dir: str, data_file: str, record: dict):
    """A sealed segment's Arrow table, every byte verified against the CRC
    record from its committed seal entry first.  A missing file or a
    mismatch raises :class:`SegmentCorruptError` — never a silent wrong
    answer."""
    path = os.path.join(seg_dir, data_file)
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise SegmentCorruptError(f"sealed segment {data_file} unreadable: {e}") from e
    err = verify_bytes(data, record)
    if err is not None:
        raise SegmentCorruptError(f"sealed segment {data_file}: {err}")
    pa = pyarrow_module()
    import pyarrow.parquet as pq

    return pq.read_table(pa.BufferReader(data))


def quarantine_segment(seg_dir: str, data_file: str) -> str:
    """Move a rotten segment (and its manifest) aside as ``*.quarantine``
    so nothing reads it again, durably (dirsync after the renames).  The
    caller fires ``table.scrub.repair`` before calling — a kill
    mid-quarantine re-detects the same CRC mismatch on resume and
    finishes the move."""
    dst = os.path.join(seg_dir, data_file + ".quarantine")
    for fname in (data_file, manifest_name(data_file)):
        src = os.path.join(seg_dir, fname)
        try:
            os.replace(src, src + ".quarantine")
        except FileNotFoundError:
            continue
    fsync_dir(seg_dir)
    return dst


# --------------------------------------------------------------- pruning
_COMPLEMENT = {"=": "!=", "!=": "=", "<": ">=", "<=": ">", ">": "<=", ">=": "<"}


def segment_may_match(zones: dict, pred) -> bool:
    """Conservative zone-map evaluator over the compiled planner's lowered
    predicate shapes (``core/sql_plan.py``'s ``cond``): False means
    provably no row in the segment can satisfy the filter, so the scan
    skips it; anything uncertain — unknown shape, column without zones,
    null-sensitive polarity — answers True.

    Null discipline: ``NaN != x`` is True and ``~(NaN < x)`` is True in
    numpy, so a negative-polarity leaf (``!=``, ``NOT IN``, a
    ``NOT``-wrapped comparison) can match null rows and is never pruned
    while the segment holds nulls.  ``IS NULL`` is never pruned at all.
    """
    return _may_match(zones, pred, False)


def _may_match(zones: dict, pred, negated: bool) -> bool:
    try:
        kind = pred[0]
        if kind == "not":
            return _may_match(zones, pred[1], not negated)
        if kind in ("and", "or"):
            a = _may_match(zones, pred[1], negated)
            b = _may_match(zones, pred[2], negated)
            # De Morgan: NOT distributes and flips the connective
            conj = (kind == "and") != negated
            return (a and b) if conj else (a or b)
        if kind == "isnull":
            return True
        z = zones.get(pred[1])
        if z is None:
            return True
        lo, hi, nulls = z["min"], z["max"], int(z["nulls"])
        if kind == "cmp":
            op = _COMPLEMENT[pred[2]] if negated else pred[2]
            lit = pred[3]
            if op == "=":
                return lo is not None and lo <= lit <= hi
            if op == "!=":
                if nulls > 0:
                    return True  # NaN != lit is True
                return lo is not None and not (lo == hi == lit)
            if nulls > 0 and negated:
                return True  # ~(NaN < lit) is True
            if lo is None:
                return False
            if op == "<":
                return lo < lit
            if op == "<=":
                return lo <= lit
            if op == ">":
                return hi > lit
            if op == ">=":
                return hi >= lit
            return True
        if nulls > 0 and (negated or kind == "notin"):
            return True  # negative polarity matches null rows (see above)
        if kind == "between":
            if lo is None:
                return False
            if negated:
                # NOT BETWEEN: some row lies outside [a, b].  (The JAX
                # package answers "no" whenever the ranges overlap, which
                # prunes segments that hold matching rows.)
                return lo < pred[2] or hi > pred[3]
            return not (hi < pred[2] or lo > pred[3])
        if kind == "in":
            vals = pred[2]
            if negated:  # NOT IN: only an all-one-value segment prunes
                return lo is None or not (lo == hi and lo in vals)
            return lo is not None and any(lo <= v <= hi for v in vals)
        if kind == "notin":
            vals = pred[2]
            if negated:  # NOT(NOT IN) = IN
                return lo is not None and any(lo <= v <= hi for v in vals)
            return lo is None or not (lo == hi and lo in vals)
        return True
    except Exception:
        return True  # malformed/unknown shape: never wrongly prune

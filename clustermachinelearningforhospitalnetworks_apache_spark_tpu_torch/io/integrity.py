"""CRC32C (Castagnoli) content checksums for persisted artifacts.

The JAX package's ``io/integrity.py``, byte for byte the same digests.
Every artifact writer (``model_io``) records the CRC32C + byte size of its
binary payloads in the JSON metadata it already writes; every loader
verifies before handing bytes to ``np.load`` — so a bit-flipped or
truncated file surfaces as a typed
:class:`~.model_io.CorruptArtifactError` at the load boundary instead of a
shape error deep inside a model.

CRC32C rather than CRC32: it is the checksum object stores and filesystems
(GCS, S3 ETags-adjacent, ext4 metadata, Parquet pages) standardize on, so
these digests stay comparable if artifacts move to such a store.  The
accelerated ``google-crc32c`` wheel is used when the environment has it;
otherwise the table-driven pure-Python :func:`crc32c_pure`, which is the
contract, or — from 256 KiB on, where the sealed segments of the
unbounded table's history reach tens of MB a scan — :func:`crc32c_lanes`,
its numpy form with the same digests.
"""

from __future__ import annotations

import numpy as np

_POLY = 0x82F63B78  # reflected Castagnoli polynomial
#: :func:`crc32c` takes :func:`crc32c_lanes` from this many bytes on
_LANES_FROM = 1 << 18

try:  # optional acceleration; the pure-Python path is the contract
    import google_crc32c as _gcrc  # type: ignore
except ImportError:
    _gcrc = None

_TABLE: list[int] | None = None


def _table() -> list[int]:
    global _TABLE
    if _TABLE is None:
        t = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ _POLY if c & 1 else c >> 1
            t.append(c)
        _TABLE = t
    return _TABLE


def crc32c(data: bytes | bytearray | memoryview, value: int = 0) -> int:
    """CRC32C of ``data``; ``value`` chains partial computations."""
    if _gcrc is not None:
        return _gcrc.extend(value, bytes(data))
    if len(memoryview(data).cast("B")) >= _LANES_FROM:
        return crc32c_lanes(data, value)
    return crc32c_pure(data, value)


def crc32c_pure(data: bytes | bytearray | memoryview, value: int = 0) -> int:
    """The table-driven pure-Python CRC32C that :func:`crc32c` falls back
    to, one byte at a time."""
    crc = value ^ 0xFFFFFFFF
    tab = _table()
    for b in memoryview(data).tobytes():
        crc = tab[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _advance(reg: int, data) -> int:
    """The raw CRC register after ``data`` (no pre- or post-inversion)."""
    tab = _table()
    for b in data:
        reg = tab[(reg ^ b) & 0xFF] ^ (reg >> 8)
    return reg


def _zeros_map(n: int) -> list[list[int]]:
    """The register's advance over ``n`` zero bytes — a linear map over
    GF(2) — as four 256-entry tables, one per register byte."""
    def apply(cols, v):
        out = 0
        j = 0
        while v:
            if v & 1:
                out ^= cols[j]
            v >>= 1
            j += 1
        return out

    one = [_advance(1 << j, b"\0") for j in range(32)]
    acc = [1 << j for j in range(32)]               # identity
    sq = one
    while n:                                        # acc = one ** n
        if n & 1:
            acc = [apply(sq, c) for c in acc]
        sq = [apply(sq, c) for c in sq]
        n >>= 1
    return [[apply(acc, v << (8 * k)) for v in range(256)] for k in range(4)]


def crc32c_lanes(data: bytes | bytearray | memoryview, value: int = 0) -> int:
    """:func:`crc32c_pure`'s digest with numpy: the bytes split into
    equal runs (4,096, or 16,384 from 16 MiB on) whose registers advance
    together, one byte of every run a step, then fold in order — each
    run's register is linear in its start, so ``reg(A + B) =
    zeros_|B|(reg(A)) ^ reg0(B)`` — and the tail that the split leaves
    runs byte by byte."""
    buf = np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)
    lanes = 16384 if buf.size >= 1 << 24 else 4096
    step = buf.size // lanes
    if step == 0:
        return crc32c_pure(data, value)
    rows = np.ascontiguousarray(buf[: step * lanes].reshape(lanes, step).T)
    tab = np.asarray(_table(), dtype=np.uint32)
    regs = np.zeros(lanes, dtype=np.uint32)
    for row in rows:
        regs = tab[(regs ^ row) & 0xFF] ^ (regs >> 8)
    z0, z1, z2, z3 = _zeros_map(step)
    reg = value ^ 0xFFFFFFFF
    for r in regs.tolist():
        reg = z0[reg & 0xFF] ^ z1[(reg >> 8) & 0xFF] ^ z2[(reg >> 16) & 0xFF] \
            ^ z3[reg >> 24] ^ r
    return _advance(reg, buf[step * lanes:].tobytes()) ^ 0xFFFFFFFF


def crc32c_hex(data: bytes | bytearray | memoryview) -> str:
    return format(crc32c(data), "08x")


def checksum_record(data: bytes) -> dict:
    """The manifest entry stored per payload file."""
    return {"crc32c": crc32c_hex(data), "size": len(data)}


def verify_bytes(data: bytes, record: dict) -> str | None:
    """→ None when ``data`` matches ``record``; else a human-readable
    mismatch description (the caller wraps it in CorruptArtifactError)."""
    size = int(record.get("size", -1))
    if size >= 0 and len(data) != size:
        return f"size mismatch: {len(data)} bytes on disk, manifest says {size}"
    want = record.get("crc32c")
    if want is not None:
        got = crc32c_hex(data)
        if got != want:
            return f"crc32c mismatch: {got} on disk, manifest says {want}"
    return None

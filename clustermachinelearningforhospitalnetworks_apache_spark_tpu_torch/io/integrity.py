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
otherwise the table-driven pure-Python :func:`crc32c_pure` (artifacts
are verified once per load — not a hot path), which is the contract.
"""

from __future__ import annotations

_POLY = 0x82F63B78  # reflected Castagnoli polynomial

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
    return crc32c_pure(data, value)


def crc32c_pure(data: bytes | bytearray | memoryview, value: int = 0) -> int:
    """The table-driven pure-Python CRC32C that :func:`crc32c` falls back
    to, one byte at a time."""
    crc = value ^ 0xFFFFFFFF
    tab = _table()
    for b in memoryview(data).tobytes():
        crc = tab[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


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

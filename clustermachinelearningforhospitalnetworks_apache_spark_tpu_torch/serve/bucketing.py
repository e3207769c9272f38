"""Shape buckets: every request batch is padded up to the smallest of a
fixed ladder of power-of-two sizes.

On the card this keeps the set of launch shapes finite and warmed ahead
of traffic: after one warmup pass over the ladder no request meets a
shape for the first time.  Pad rows are sliced off on the way out;
predictions are row-local, so padding never leaks into a real row's
result.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Iterator, Sequence, Tuple

import numpy as np

#: default ladder: singles ride the 1-bucket, bulk requests cap at 1024
#: rows per executable — larger inputs are split (see :func:`iter_chunks`).
DEFAULT_BUCKETS: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def validate_buckets(buckets: Sequence[int]) -> tuple[int, ...]:
    """Sorted, deduplicated, all-positive bucket ladder."""
    out = tuple(sorted(set(int(b) for b in buckets)))
    if not out or out[0] < 1:
        raise ValueError(f"buckets must be positive ints, got {buckets!r}")
    return out


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket ≥ ``n`` (callers split inputs larger than the top
    bucket with :func:`iter_chunks` first)."""
    if n < 1:
        raise ValueError(f"need at least one row, got {n}")
    i = bisect_left(buckets, n)
    if i == len(buckets):
        raise ValueError(
            f"batch of {n} rows exceeds the largest bucket {buckets[-1]}; "
            "split it with iter_chunks()"
        )
    return buckets[i]


def fill_ratio(n_valid: int, bucket: int) -> float:
    """The share of a padded batch that is real rows; the batcher's
    coalescing pushes it toward 1.0."""
    return n_valid / bucket if bucket else 0.0


def pad_to_bucket(x: np.ndarray, bucket: int) -> np.ndarray:
    """Zero-pad rows up to ``bucket`` (no-op view when already full)."""
    n = x.shape[0]
    if n == bucket:
        return x
    if n > bucket:
        raise ValueError(f"{n} rows do not fit bucket {bucket}")
    out = np.zeros((bucket,) + x.shape[1:], dtype=x.dtype)
    out[:n] = x
    return out


def iter_chunks(
    x: np.ndarray, max_bucket: int
) -> Iterator[Tuple[int, np.ndarray]]:
    """Split an arbitrarily large request into ≤``max_bucket``-row pieces,
    yielding ``(start_row, piece)`` — full pieces reuse the top bucket's
    executable, the tail pads into whatever bucket fits it."""
    n = x.shape[0]
    for s in range(0, n, max_bucket):
        yield s, x[s : s + max_bucket]

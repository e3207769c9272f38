"""LIBSVM data source — ``spark.read.format("libsvm")`` parity (the JAX
package's ``io/libsvm.py``; host work).

Spark MLlib's example-data format (``label idx:val idx:val …`` with
1-based, strictly ascending indices).  The reference script never reads
libsvm, but every MLlib walkthrough ships its sample data in it.
Features materialize dense (the port's rows are dense tensors; the
sparse-to-dense widening happens once, at read), and a file written by
either package reads the same in the other.
"""

from __future__ import annotations

import numpy as np

__all__ = ["read_libsvm", "write_libsvm"]


def read_libsvm(
    path: str,
    n_features: int | None = None,
    zero_based: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """→ (features (n, d) float32, labels (n,) float32).

    ``n_features`` pads/validates the width (Spark's ``numFeatures``
    option); by default the max seen index decides.  ``zero_based=True``
    reads 0-based indices (sklearn's dump convention) instead of
    libsvm/Spark's 1-based."""
    labels: list[float] = []
    rows: list[list[tuple[int, float]]] = []
    max_idx = -1
    base = 0 if zero_based else 1
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.split("#", 1)[0].strip()  # strip trailing comments
            if not line:
                continue
            parts = line.split()
            try:
                labels.append(float(parts[0]))
            except ValueError:
                raise ValueError(
                    f"{path}:{ln}: label {parts[0]!r} is not numeric"
                ) from None
            row: list[tuple[int, float]] = []
            prev = -1
            for p in parts[1:]:
                try:
                    idx_s, val_s = p.split(":", 1)
                    idx = int(idx_s) - base
                    val = float(val_s)
                except ValueError:
                    raise ValueError(
                        f"{path}:{ln}: malformed feature {p!r} "
                        "(expected index:value)"
                    ) from None
                if idx < 0:
                    raise ValueError(
                        f"{path}:{ln}: feature index {idx_s} below the "
                        f"{'0' if zero_based else '1'}-based minimum"
                    )
                if idx <= prev:
                    raise ValueError(
                        f"{path}:{ln}: feature indices must be strictly "
                        f"ascending (saw {idx + base} after {prev + base})"
                    )
                prev = idx
                row.append((idx, val))
                max_idx = max(max_idx, idx)
            rows.append(row)
    d = (max_idx + 1) if n_features is None else int(n_features)
    if n_features is not None and max_idx >= d:
        raise ValueError(
            f"{path}: feature index {max_idx + base} exceeds "
            f"n_features={n_features}"
        )
    x = np.zeros((len(rows), d), dtype=np.float32)
    for i, row in enumerate(rows):
        for idx, val in row:
            x[i, idx] = val
    return x, np.asarray(labels, dtype=np.float32)


def write_libsvm(path: str, x: np.ndarray, y: np.ndarray) -> None:
    """Write (features, labels) in 1-based libsvm format, omitting zeros
    (the round-trip inverse of :func:`read_libsvm`)."""
    x = np.asarray(x)
    y = np.asarray(y).reshape(-1)
    if x.shape[0] != y.shape[0]:
        raise ValueError(f"rows mismatch: x has {x.shape[0]}, y has {y.shape[0]}")
    with open(path, "w") as f:
        for i in range(x.shape[0]):
            nz = np.flatnonzero(x[i] != 0)
            # 9 significant digits round-trip float32 exactly (%g's 6 do not)
            feats = " ".join(f"{j + 1}:{x[i, j]:.9g}" for j in nz)
            lab = f"{y[i]:.9g}"
            f.write(f"{lab} {feats}\n" if feats else f"{lab}\n")

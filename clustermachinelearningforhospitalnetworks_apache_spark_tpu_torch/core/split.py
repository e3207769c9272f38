"""Seeded random splits (``DataFrame.randomSplit([0.7, 0.3], seed=42)``).

The permutation is ``jax.random.permutation(jax.random.key(seed), n)`` of
the JAX package's ``core/split.py``, drawn by the port's threefry
(``prng.py``), so both packages split a table identically.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .. import prng
from .table import Table


def split_indices(n: int, weights: Sequence[float], seed: int) -> list[np.ndarray]:
    w = np.asarray(weights, dtype=np.float64)
    if np.any(w < 0) or w.sum() <= 0:
        raise ValueError(f"bad split weights {weights}")
    w = w / w.sum()
    perm = prng.permutation(prng.key(seed), n).numpy()
    bounds = np.floor(np.cumsum(w) * n + 0.5).astype(int)
    bounds[-1] = n
    out, lo = [], 0
    for hi in bounds:
        out.append(np.sort(perm[lo:hi]))
        lo = hi
    return out


def random_split(table: Table, weights: Sequence[float], seed: int = 42) -> list[Table]:
    parts = split_indices(len(table), weights, seed)
    return [table.mask(idx) for idx in parts]


def train_test_split(table: Table, train_fraction: float = 0.7, seed: int = 42):
    a, b = random_split(table, [train_fraction, 1.0 - train_fraction], seed)
    return a, b

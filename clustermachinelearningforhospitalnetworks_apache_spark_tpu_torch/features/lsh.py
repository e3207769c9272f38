"""Locality-sensitive hashing (the JAX package's ``features/lsh.py``) —
``pyspark.ml.feature``'s two LSH families.

``BucketedRandomProjectionLSH`` (Euclidean) and ``MinHashLSH`` (Jaccard),
each with Spark's model surface: ``transform`` (append per-table hash
values), ``approx_nearest_neighbors`` and ``approx_similarity_join``.

Host numpy in both packages, so no ``device=``:

- **Random-projection hashing is one matmul** in double precision:
  ``floor(X @ Vᵀ / bucketLength)`` for an (n, d) matrix against (T, d)
  unit Gaussian projections.  Bucket ids must be exact — see ``_hashes``.
- **MinHash needs exact integer modular arithmetic** (products of ~2³¹
  residues, exact only in 64-bit ints); the (T, d) per-index hash table
  is built once in int64 and the per-row masked min runs in numpy.
- **Bucket bookkeeping** (grouping rows by hash value) is ragged and
  data-dependent; candidate-pair expansion is a vectorized sort-merge
  (``searchsorted`` + ``repeat``), never a Python loop over rows.

Spark parity notes: MinHash uses Spark's hash family
``h(j) = ((1 + j)·a + b) mod 2038074743`` (MinHashLSH.HASH_PRIME) over
the indices of non-zero entries; ``approx_nearest_neighbors`` follows
Spark's single-probe semantics — only rows sharing at least one bucket
with the key are candidates, so fewer than k rows can be returned.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.table import Table
from ..io.model_io import register_model
from .assembler import AssembledTable
from .selector import _as_matrix, _Saveable

#: Spark's MinHashLSH.HASH_PRIME
_MINHASH_PRIME = 2038074743


def _candidate_pairs(ha: np.ndarray, hb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(idx_a, idx_b) pairs sharing a bucket in ≥1 of the T hash tables.

    Vectorized sort-merge per table: sort side B's bucket ids once, then
    every A row's matching B range comes from two ``searchsorted`` calls;
    the ragged ranges expand with the standard repeat/cumsum trick.
    Pairs found by several tables dedupe through one ``np.unique`` on the
    fused pair id."""
    n_b = hb.shape[0]
    out = []
    for t in range(ha.shape[1]):
        order = np.argsort(hb[:, t], kind="stable")
        sb = hb[order, t]
        left = np.searchsorted(sb, ha[:, t], side="left")
        right = np.searchsorted(sb, ha[:, t], side="right")
        counts = right - left
        if not counts.any():
            continue
        ia = np.repeat(np.arange(ha.shape[0]), counts)
        # offsets within each run: arange minus the run's start
        starts = np.repeat(left, counts)
        within = np.arange(counts.sum()) - np.repeat(
            np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
        )
        ib = order[starts + within]
        out.append(ia.astype(np.int64) * n_b + ib.astype(np.int64))
    if not out:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    fused = np.unique(np.concatenate(out))
    return fused // n_b, fused % n_b


class _LSHModelBase(_Saveable):
    """Shared candidate-generation + verification skeleton; subclasses
    supply ``_hashes(x)`` and ``_distances(xa, xb)``."""

    #: prefix for the appended per-table hash columns on Table inputs
    output_col: str = "hashes"

    def transform(self, data):
        """Raw arrays → the (n, num_hash_tables) integer hash matrix.
        ``AssembledTable`` → the SAME features with ``hashes_<t>`` columns
        appended to the underlying table — Spark's LSH transform adds
        ``outputCol`` and leaves ``inputCol`` intact, so an LSH stage
        mid-Pipeline must not replace the feature matrix with bucket
        ids."""
        h = self._hashes(_as_matrix(data))
        if not isinstance(data, AssembledTable):
            return h
        cols = dict(data.table.columns)
        for t in range(h.shape[1]):
            cols[f"{self.output_col}_{t}"] = h[:, t]
        return AssembledTable(
            table=Table.from_dict(cols),
            feature_cols=data.feature_cols,
            features=data.features,
            output_col=data.output_col,
        )

    def hash_matrix(self, data) -> np.ndarray:
        """(n, num_hash_tables) integer hash values for any input."""
        return self._hashes(_as_matrix(data))

    def approx_nearest_neighbors(
        self, data, key, k: int, *, return_distances: bool = True
    ):
        """Indices of (≤ k) nearest rows among hash-bucket candidates,
        ascending by exact distance; with ``return_distances``, a
        ``(indices, distances)`` tuple (Spark returns the joined rows +
        ``distCol``; indices into ``data`` are this framework's row
        handle)."""
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        x = _as_matrix(data)
        key = np.asarray(key, np.float64).reshape(1, -1)
        if key.shape[1] != x.shape[1]:
            raise ValueError(
                f"key has {key.shape[1]} features, dataset has {x.shape[1]}"
            )
        cand, _ = _candidate_pairs(self._hashes(x), self._hashes(key))
        if cand.size == 0:
            empty = np.empty(0, np.int64)
            return (empty, np.empty(0)) if return_distances else empty
        d = self._distances(x[cand], key)
        order = np.argsort(d, kind="stable")[:k]
        idx = cand[order]
        return (idx, d[order]) if return_distances else idx

    def approx_similarity_join(self, a, b, threshold: float):
        """(idx_a, idx_b, distance) for candidate pairs with exact
        distance ≤ threshold (Spark's ``approxSimilarityJoin`` with
        ``distCol`` materialized as the third array)."""
        if threshold < 0:
            raise ValueError(f"threshold must be >= 0, got {threshold}")
        xa, xb = _as_matrix(a), _as_matrix(b)
        if xa.shape[1] != xb.shape[1]:
            raise ValueError(
                f"feature widths differ: {xa.shape[1]} vs {xb.shape[1]}"
            )
        ia, ib = _candidate_pairs(self._hashes(xa), self._hashes(xb))
        if ia.size == 0:
            return ia, ib, np.empty(0)
        d = self._distances(xa[ia], xb[ib])
        keep = d <= threshold
        return ia[keep], ib[keep], d[keep]


@register_model("BucketedRandomProjectionLSHModel")
@dataclass(frozen=True)
class BucketedRandomProjectionLSHModel(_LSHModelBase):
    """``projections``: (num_hash_tables, d) unit Gaussian directions;
    hash = ⌊x·v / bucketLength⌋ (Spark's EuclideanDistance family)."""

    projections: np.ndarray
    bucket_length: float

    def _hashes(self, x: np.ndarray) -> np.ndarray:
        # ONE (n, d) @ (d, T) matmul for all tables.  Double precision,
        # matching Spark's double hashing: bucket ids must be EXACT — at
        # f32, features of magnitude ~1e8 have ~8-unit ULP spacing, which
        # silently collapses distinct buckets whenever bucket_length < ULP.
        return np.floor(
            x @ self.projections.T / self.bucket_length
        ).astype(np.int64)

    def _distances(self, xa: np.ndarray, xb: np.ndarray) -> np.ndarray:
        diff = xa - xb
        return np.sqrt(np.einsum("nd,nd->n", diff, diff))

    def _artifacts(self):
        return (
            "BucketedRandomProjectionLSHModel",
            {"bucket_length": float(self.bucket_length)},
            {"projections": np.asarray(self.projections, np.float32)},
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(
            projections=np.asarray(arrays["projections"], np.float64),
            bucket_length=float(params["bucket_length"]),
        )


@dataclass(frozen=True)
class BucketedRandomProjectionLSH:
    """Spark params: ``bucket_length`` (required, > 0), ``num_hash_tables``
    (default 1), ``seed``."""

    bucket_length: float = 0.0
    num_hash_tables: int = 1
    seed: int = 0

    def fit(self, data, label_col=None, mesh=None) -> BucketedRandomProjectionLSHModel:
        """The hash draws, on the host (``mesh`` is accepted and unused, as
        in the reference: the draws do not read the rows)."""
        if self.bucket_length <= 0:
            raise ValueError(
                f"bucket_length must be > 0, got {self.bucket_length}"
            )
        if self.num_hash_tables < 1:
            raise ValueError(
                f"num_hash_tables must be >= 1, got {self.num_hash_tables}"
            )
        d = _as_matrix(data).shape[1]
        rng = np.random.default_rng(self.seed)
        v = rng.normal(size=(self.num_hash_tables, d))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        return BucketedRandomProjectionLSHModel(
            projections=v, bucket_length=float(self.bucket_length)
        )


@register_model("MinHashLSHModel")
@dataclass(frozen=True)
class MinHashLSHModel(_LSHModelBase):
    """``coef_a``/``coef_b``: (num_hash_tables,) ints of Spark's hash
    family; hash = min over non-zero indices j of
    ((1 + j)·a + b) mod HASH_PRIME."""

    coef_a: np.ndarray
    coef_b: np.ndarray

    def _hashes(self, x: np.ndarray) -> np.ndarray:
        if (x < 0).any():
            raise ValueError("MinHashLSH input must be non-negative (binary)")
        active = x > 0
        if not active.any(axis=1).all():
            raise ValueError(
                "MinHashLSH: every row needs at least one non-zero entry "
                "(Spark raises on empty sets too)"
            )
        d = x.shape[1]
        j = np.arange(1, d + 1, dtype=np.int64)
        # (T, d) per-index hash values — EXACT int64 modular arithmetic
        # (residue products reach ~2^62)
        table = (j[None, :] * self.coef_a[:, None] + self.coef_b[:, None]) % _MINHASH_PRIME
        big = np.int64(_MINHASH_PRIME)  # sentinel > any residue
        out = np.empty((x.shape[0], table.shape[0]), np.int64)
        for t in range(table.shape[0]):   # T is small (hash tables, not data)
            out[:, t] = np.where(active, table[t][None, :], big).min(axis=1)
        return out

    def _distances(self, xa: np.ndarray, xb: np.ndarray) -> np.ndarray:
        a, b = xa > 0, xb > 0
        inter = (a & b).sum(axis=1)
        union = (a | b).sum(axis=1)
        return 1.0 - inter / np.maximum(union, 1)

    def _artifacts(self):
        return (
            "MinHashLSHModel",
            {},
            {
                "coef_a": np.asarray(self.coef_a, np.int64),
                "coef_b": np.asarray(self.coef_b, np.int64),
            },
        )

    @classmethod
    def from_artifacts(cls, params, arrays):
        return cls(
            coef_a=np.asarray(arrays["coef_a"], np.int64),
            coef_b=np.asarray(arrays["coef_b"], np.int64),
        )


@dataclass(frozen=True)
class MinHashLSH:
    """Spark params: ``num_hash_tables`` (default 1), ``seed``.  Input
    rows are treated as sets: the indices of the non-zero entries."""

    num_hash_tables: int = 1
    seed: int = 0

    def fit(self, data, label_col=None, mesh=None) -> MinHashLSHModel:
        """The hash draws, on the host (``mesh`` accepted and unused)."""
        if self.num_hash_tables < 1:
            raise ValueError(
                f"num_hash_tables must be >= 1, got {self.num_hash_tables}"
            )
        _ = _as_matrix(data).shape[1]  # validates rectangular numeric input
        rng = np.random.default_rng(self.seed)
        return MinHashLSHModel(
            coef_a=rng.integers(1, _MINHASH_PRIME, size=self.num_hash_tables),
            coef_b=rng.integers(0, _MINHASH_PRIME, size=self.num_hash_tables),
        )


__all__ = [
    "BucketedRandomProjectionLSH", "BucketedRandomProjectionLSHModel", "MinHashLSH",
    "MinHashLSHModel",
]

"""Mergeable per-feature distribution sketches + PSI drift scoring.

The training half of distribution-drift detection: while a model fits,
each feature's distribution is summarized into a :class:`FeatureSketch`
(count / mean / M2 moments, min/max, and a fixed-edge histogram).  The
sketch is **mergeable** — two sketches over the same bin edges combine
exactly (Chan's parallel moment merge + bin-count addition), so shards
or micro-batches can be profiled independently and reduced, the same
shape as every other reduction in this framework.

A :class:`DataProfile` (one sketch per feature) rides in the model
artifact's metadata (``io/model_io.py``) and becomes the *reference*
distribution.  At serve/stream time a live profile with the reference's
bin edges accumulates the traffic actually seen, and
:func:`population_stability_index` compares the two:

    PSI = Σ_bins (q_i − p_i) · ln(q_i / p_i)

with the usual reading: < 0.1 stable, 0.1–0.25 moderate shift, > 0.25
population drift.  Out-of-range mass lands in explicit underflow /
overflow bins, so a unit change (hours→minutes) that pushes every value
past the reference max is maximally visible instead of silently clipped.

Everything here is host-side numpy — profiles are computed on data that
is already host-resident at the ingest/serve boundary, and they must be
JSON-serializable into artifact metadata.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np

#: conventional PSI reading thresholds (Siddiqi): surfaces in health()
PSI_STABLE = 0.1
PSI_DRIFT = 0.25

_DEFAULT_BINS = 16


def _edges_from_values(values: np.ndarray, bins: int) -> np.ndarray:
    """Quantile bin edges over the finite values (equal-mass reference
    bins make PSI sensitive to shape changes, not just mean shifts)."""
    v = values[np.isfinite(values)]
    if v.size == 0:
        return np.array([0.0, 1.0])
    edges = np.unique(np.quantile(v, np.linspace(0.0, 1.0, bins + 1)))
    if edges.size < 2:  # constant column: one degenerate edge
        c = float(edges[0]) if edges.size else 0.0
        edges = np.array([c - 0.5, c + 0.5])
    return edges.astype(np.float64)


@dataclass
class FeatureSketch:
    """Moments + fixed-edge histogram for ONE feature.

    ``counts`` has ``len(edges) + 1`` entries: ``counts[0]`` is the
    underflow bin (< edges[0]), ``counts[-1]`` the overflow bin
    (≥ edges[-1]), and ``counts[1:-1]`` the interior bins.  NaN/Inf
    values are counted in ``n_invalid`` and excluded from everything
    else.
    """

    edges: np.ndarray
    counts: np.ndarray = field(default=None)  # type: ignore[assignment]
    count: float = 0.0
    mean: float = 0.0
    m2: float = 0.0
    min: float = float("inf")
    max: float = float("-inf")
    n_invalid: float = 0.0

    def __post_init__(self) -> None:
        self.edges = np.asarray(self.edges, dtype=np.float64)
        if self.edges.size < 2:
            raise ValueError("FeatureSketch needs at least 2 bin edges")
        if self.counts is None:
            self.counts = np.zeros(self.edges.size + 1, dtype=np.float64)
        else:
            self.counts = np.asarray(self.counts, dtype=np.float64)
            if self.counts.size != self.edges.size + 1:
                raise ValueError(
                    f"counts size {self.counts.size} != edges+1 "
                    f"({self.edges.size + 1})"
                )

    # ------------------------------------------------------------ update
    def update(self, values: np.ndarray) -> "FeatureSketch":
        """Fold a batch of values in (vectorized); returns self."""
        v = np.asarray(values, dtype=np.float64).ravel()
        ok = np.isfinite(v)
        self.n_invalid += float(v.size - int(ok.sum()))
        v = v[ok]
        if v.size == 0:
            return self
        # histogram: searchsorted puts < edges[0] at 0 (underflow) and
        # ≥ edges[-1] at len(edges) (overflow)
        idx = np.searchsorted(self.edges, v, side="right")
        idx[v == self.edges[-1]] = self.edges.size - 1  # max edge → last bin
        self.counts += np.bincount(idx, minlength=self.counts.size).astype(
            np.float64
        )
        # Chan merge of (count, mean, m2) with the batch's own moments
        bn = float(v.size)
        bmean = float(v.mean())
        bm2 = float(((v - bmean) ** 2).sum())
        delta = bmean - self.mean
        tot = self.count + bn
        self.mean += delta * bn / tot
        self.m2 += bm2 + delta * delta * self.count * bn / tot
        self.count = tot
        self.min = min(self.min, float(v.min()))
        self.max = max(self.max, float(v.max()))
        return self

    def merge(self, other: "FeatureSketch") -> "FeatureSketch":
        """Exact merge of two sketches over the SAME edges; returns self."""
        if self.edges.size != other.edges.size or not np.allclose(
            self.edges, other.edges
        ):
            raise ValueError("cannot merge sketches with different bin edges")
        if other.count > 0:
            delta = other.mean - self.mean
            tot = self.count + other.count
            self.mean += delta * other.count / tot
            self.m2 += other.m2 + delta * delta * self.count * other.count / tot
            self.count = tot
            self.min = min(self.min, other.min)
            self.max = max(self.max, other.max)
        self.counts = self.counts + other.counts
        self.n_invalid += other.n_invalid
        return self

    # ------------------------------------------------------------ stats
    @property
    def std(self) -> float:
        return float(np.sqrt(self.m2 / self.count)) if self.count > 1 else 0.0

    def approx_quantile(self, q: float) -> float:
        """Histogram-interpolated quantile estimate (interior mass only)."""
        inner = self.counts[1:-1]
        total = inner.sum()
        if total <= 0:
            return float("nan")
        cum = np.cumsum(inner)
        target = q * total
        i = int(np.searchsorted(cum, target))
        i = min(i, inner.size - 1)
        prev = cum[i - 1] if i > 0 else 0.0
        frac = 0.0 if inner[i] == 0 else (target - prev) / inner[i]
        lo, hi = self.edges[i], self.edges[i + 1]
        return float(lo + frac * (hi - lo))

    # ------------------------------------------------------------ persist
    def to_dict(self) -> dict:
        return {
            "edges": [float(e) for e in self.edges],
            "counts": [float(c) for c in self.counts],
            "count": self.count,
            "mean": self.mean,
            "m2": self.m2,
            "min": None if not np.isfinite(self.min) else self.min,
            "max": None if not np.isfinite(self.max) else self.max,
            "n_invalid": self.n_invalid,
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "FeatureSketch":
        return cls(
            edges=np.asarray(d["edges"], dtype=np.float64),
            counts=np.asarray(d["counts"], dtype=np.float64),
            count=float(d.get("count", 0.0)),
            mean=float(d.get("mean", 0.0)),
            m2=float(d.get("m2", 0.0)),
            min=float("inf") if d.get("min") is None else float(d["min"]),
            max=float("-inf") if d.get("max") is None else float(d["max"]),
            n_invalid=float(d.get("n_invalid", 0.0)),
        )

    @classmethod
    def like(cls, other: "FeatureSketch") -> "FeatureSketch":
        """Empty sketch over the same edges (the live-side constructor)."""
        return cls(edges=other.edges.copy())


def population_stability_index(
    reference: FeatureSketch, live: FeatureSketch, eps: float | None = None
) -> float:
    """PSI between a reference and a live sketch over the same edges.

    Proportions are smoothed by ``eps`` so an empty bin contributes a
    large-but-finite term instead of ±inf.  The default is
    sample-size-aware — ``max(1e-4, 1/(2·live_rows))`` — because with a
    small live window a fixed tiny eps makes every *unhit* bin look like
    vanished mass (~0.35 PSI each), swamping the signal; a Laplace-scale
    floor keeps small-window noise bounded while leaving the large-n
    behavior unchanged.  Returns 0.0 when the live sketch has seen
    nothing (no evidence is not drift).
    """
    p = np.asarray(reference.counts, dtype=np.float64)
    q = np.asarray(live.counts, dtype=np.float64)
    if q.sum() <= 0 or p.sum() <= 0:
        return 0.0
    if eps is None:
        eps = max(1e-4, 1.0 / (2.0 * q.sum()))
    p = np.maximum(p / p.sum(), eps)
    q = np.maximum(q / q.sum(), eps)
    p /= p.sum()
    q /= q.sum()
    return float(np.sum((q - p) * np.log(q / p)))


@dataclass
class DataProfile:
    """One :class:`FeatureSketch` per feature, in a fixed feature order —
    the unit that rides in the model manifest."""

    names: tuple[str, ...]
    sketches: dict[str, FeatureSketch]

    # ------------------------------------------------------------ build
    @classmethod
    def from_matrix(
        cls,
        x: np.ndarray,
        names: Sequence[str],
        bins: int = _DEFAULT_BINS,
    ) -> "DataProfile":
        """Profile a (n, d) training matrix: quantile edges per column,
        then one vectorized update.  Each column's sketch is computed
        alone, in the same float64 operations whichever thread runs it, so
        the columns are sketched on a thread each (numpy's partition,
        searchsorted and reductions release the GIL)."""
        x = np.asarray(x, dtype=np.float64)
        if x.ndim != 2 or x.shape[1] != len(names):
            raise ValueError(
                f"matrix shape {x.shape} does not match {len(names)} names"
            )

        def sketch(j: int) -> FeatureSketch:
            col = x[:, j]
            sk = FeatureSketch(edges=_edges_from_values(col, bins))
            return sk.update(col)

        workers = max(1, min(len(names), os.cpu_count() or 1))
        with ThreadPoolExecutor(workers) as ex:
            done = list(ex.map(sketch, range(len(names))))
        return cls(names=tuple(names), sketches=dict(zip(names, done)))

    @classmethod
    def like(cls, reference: "DataProfile") -> "DataProfile":
        """Empty profile with the reference's edges — the live side."""
        return cls(
            names=reference.names,
            sketches={
                n: FeatureSketch.like(s) for n, s in reference.sketches.items()
            },
        )

    # ------------------------------------------------------------ update
    def update_matrix(self, x: np.ndarray) -> "DataProfile":
        """Fold a (n, d) batch in, columns in ``self.names`` order."""
        x = np.asarray(x, dtype=np.float64)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[1] != len(self.names):
            raise ValueError(
                f"matrix width {x.shape[1]} != profile width {len(self.names)}"
            )
        for j, name in enumerate(self.names):
            self.sketches[name].update(x[:, j])
        return self

    def merge(self, other: "DataProfile") -> "DataProfile":
        if self.names != other.names:
            raise ValueError(
                f"profiles cover different features: {self.names} vs {other.names}"
            )
        for n in self.names:
            self.sketches[n].merge(other.sketches[n])
        return self

    @property
    def total_rows(self) -> float:
        if not self.names:
            return 0.0
        return self.sketches[self.names[0]].count

    # ------------------------------------------------------------ score
    def psi_against(self, live: "DataProfile") -> dict[str, float]:
        """Per-feature PSI of ``live`` (observed) against self (reference)."""
        if self.names != live.names:
            raise ValueError("profiles cover different features")
        return {
            n: population_stability_index(self.sketches[n], live.sketches[n])
            for n in self.names
        }

    # ------------------------------------------------------------ persist
    def to_dict(self) -> dict:
        return {
            "names": list(self.names),
            "sketches": {n: s.to_dict() for n, s in self.sketches.items()},
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "DataProfile":
        names = tuple(d["names"])
        return cls(
            names=names,
            sketches={
                n: FeatureSketch.from_dict(d["sketches"][n]) for n in names
            },
        )

"""Per-tenant feature sketches as STACKED arrays (the JAX package's
``farm/profiles.py``; host numpy).

A 4k-tenant farm cannot afford 4k × d ``FeatureSketch`` objects in its
JSON manifest; it stores the same information as three npz arrays —
shared quantile edges ``(d, B+1)``, per-tenant histogram counts
``(T, d, B+2)`` (under/overflow bins, the ``quality/sketches.py``
layout), and per-tenant moments ``(T, d, 5)`` = (count, mean, m2, min,
max).  Edges are SHARED across tenants (quantiles of the pooled data),
which is what makes the sketches mergeable farm-wide: any subset of
tenants (or a refit's refreshed rows) adds bin counts and Chan-merges
moments against the same reference grid, and per-tenant PSI scores live
traffic against the tenant's own counts over those edges.

Everything vectorized host numpy: one ``searchsorted`` + offset
``bincount`` per feature covers all T tenants at once.
"""

from __future__ import annotations

import numpy as np

from ..quality.sketches import DataProfile, FeatureSketch

_DEFAULT_BINS = 16


def shared_edges(x: np.ndarray, w: np.ndarray, bins: int) -> np.ndarray:
    """(d, bins+1) strictly-increasing quantile edges over the pooled
    valid rows.  Duplicate quantiles (heavy ties / constant columns) are
    bumped by a tiny cumulative epsilon so the array stays fixed-width —
    unlike ``sketches._edges_from_values``, which dedupes to a ragged
    length a stacked layout can't hold."""
    t, r, d = x.shape
    valid = w.reshape(-1) > 0
    flat = x.reshape(-1, d)[valid]
    edges = np.empty((d, bins + 1), dtype=np.float64)
    q = np.linspace(0.0, 1.0, bins + 1)
    for j in range(d):
        col = flat[:, j] if flat.shape[0] else np.zeros((1,))
        col = col[np.isfinite(col)]
        if col.size == 0:
            col = np.zeros((1,))
        e = np.quantile(col, q)
        e = np.maximum.accumulate(e)
        span = max(float(e[-1] - e[0]), 1.0)
        dup = np.diff(e, prepend=e[0] - 1.0) <= 0
        e = e + np.cumsum(dup) * (1e-9 * span)
        edges[j] = e
    return edges


def build_profile_stack(
    x: np.ndarray,
    w: np.ndarray,
    names,
    bins: int = _DEFAULT_BINS,
    edges: np.ndarray | None = None,
) -> dict[str, np.ndarray]:
    """(T, R, d) padded data + mask → the stacked-sketch arrays.

    Pass ``edges`` to bin against an EXISTING farm's reference grid (a
    refit must stay comparable/mergeable with the tenants it didn't
    touch); otherwise fresh pooled-quantile edges are computed."""
    t, r, d = x.shape
    if len(names) != d:
        raise ValueError(f"{len(names)} names for {d} features")
    if edges is None:
        edges = shared_edges(x, w, bins)
    edges = np.asarray(edges, dtype=np.float64)
    n_bins = edges.shape[1] + 1  # + under/overflow
    counts = np.zeros((t, d, n_bins), dtype=np.float64)
    stats = np.zeros((t, d, 5), dtype=np.float64)
    valid = w > 0  # (T, R)
    n_t = valid.sum(axis=1).astype(np.float64)  # (T,)
    tenant_of = np.broadcast_to(np.arange(t)[:, None], (t, r))
    for j in range(d):
        vals = x[:, :, j].astype(np.float64)
        idx = np.searchsorted(edges[j], vals, side="right")
        idx[vals == edges[j][-1]] = edges.shape[1] - 1  # top edge → last bin
        flat = (tenant_of * n_bins + idx)[valid]
        counts[:, j, :] = np.bincount(
            flat, minlength=t * n_bins
        ).reshape(t, n_bins)
        vsum = np.where(valid, vals, 0.0).sum(axis=1)
        mean = np.divide(
            vsum, n_t, out=np.zeros_like(vsum), where=n_t > 0
        )
        m2 = (np.where(valid, (vals - mean[:, None]) ** 2, 0.0)).sum(axis=1)
        vmin = np.where(valid, vals, np.inf).min(axis=1)
        vmax = np.where(valid, vals, -np.inf).max(axis=1)
        stats[:, j, 0] = n_t
        stats[:, j, 1] = mean
        stats[:, j, 2] = m2
        stats[:, j, 3] = vmin
        stats[:, j, 4] = vmax
    return {
        "profile_edges": edges,
        "profile_counts": counts,
        "profile_stats": stats,
    }


def tenant_sketch(arrays: dict, i: int, j: int) -> FeatureSketch:
    """Rebuild tenant ``i``'s sketch for feature column ``j``."""
    stats = arrays["profile_stats"][i, j]
    masked = arrays.get("masked_rows")
    n_invalid = (
        float(masked[i]) if masked is not None and i < len(masked) else 0.0
    )
    return FeatureSketch(
        edges=np.asarray(arrays["profile_edges"][j], dtype=np.float64),
        counts=np.asarray(arrays["profile_counts"][i, j], dtype=np.float64),
        count=float(stats[0]),
        mean=float(stats[1]),
        m2=float(stats[2]),
        min=float(stats[3]) if np.isfinite(stats[3]) else float("inf"),
        max=float(stats[4]) if np.isfinite(stats[4]) else float("-inf"),
        n_invalid=n_invalid,
    )


def profile_of(arrays: dict, names, i: int) -> DataProfile:
    """Tenant ``i``'s stacked rows → an ordinary :class:`DataProfile`
    (the drift-scoring and merge surface the rest of the repo speaks)."""
    names = tuple(names)
    return DataProfile(
        names=names,
        sketches={
            n: tenant_sketch(arrays, i, j) for j, n in enumerate(names)
        },
    )

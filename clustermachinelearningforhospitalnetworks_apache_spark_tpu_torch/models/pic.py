"""PowerIterationClustering (the JAX package's ``models/pic.py``;
``pyspark.ml.clustering.PowerIterationClustering``).

Lin & Cohen's PIC: truncated power iteration of the row-normalized
affinity matrix W = D⁻¹A converges (before the trivial all-ones
eigenvector dominates) to a 1-D embedding in which clusters separate;
k-means on that embedding assigns the clusters.

The (symmetrized) affinity is a dense matrix on ``device`` (default the
card) and each iteration is one matrix-vector product; the k-means step
is the port's ``KMeans`` on the (n, 1) embedding (K1 a Lloyd step, K2 in
predict on the card).  Dense (n, n) is the honest trade for this
estimator's scale (Spark's own docs position PIC for up to ~10⁵ nodes);
beyond the node budget it raises rather than thrash.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from .base import Estimator

#: dense-affinity node budget (f32 n² must fit comfortably in device memory)
_MAX_NODES = 40_000


def _power_iterate(w_norm, v0, max_iter: int):
    v = v0
    for _ in range(max_iter):
        v = w_norm @ v
        # L1 normalization (Lin & Cohen) keeps the iterate from vanishing
        v = v / torch.clamp(torch.sum(torch.abs(v)), min=1e-30)
    return v


def _build_affinity(src, dst, w, n: int) -> np.ndarray:
    """Symmetrized dense (n, n) affinity from edge triplets.

    Spark requires symmetric affinities; either orientation is accepted
    and duplicates fold additively.  Self-loops (src == dst) are folded
    exactly once — symmetrization must not double the diagonal.
    """
    a = np.zeros((n, n), np.float32)
    np.add.at(a, (src, dst), w)
    off_diag = src != dst
    np.add.at(a, (dst[off_diag], src[off_diag]), w[off_diag])
    return a


@dataclass(frozen=True)
class PowerIterationClustering(Estimator):
    """Spark defaults: k 2, maxIter 20, initMode "random" (or "degree").
    ``assign_clusters`` consumes (src, dst, weight) affinity triplets and
    returns per-node cluster assignments — Spark's API shape (PIC is a
    transformer-less estimator there too)."""

    k: int = 2
    max_iter: int = 20
    init_mode: str = "random"
    seed: int = 0

    def embed(self, src, dst, weight=None, device=None) -> np.ndarray:
        """(n,) float64 power-iteration embedding of the nodes, computed on
        ``device`` (default the card)."""
        if self.k < 2:
            raise ValueError(f"k must be >= 2, got {self.k}")
        if self.init_mode not in ("random", "degree"):
            raise ValueError(
                f"init_mode must be random|degree, got {self.init_mode!r}"
            )
        dev = resolve_device(device)
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        if src.shape != dst.shape or src.ndim != 1:
            raise ValueError("src/dst must be equal-length 1-D id arrays")
        if len(src) == 0:
            raise ValueError("PowerIterationClustering on an empty affinity")
        if src.min() < 0 or dst.min() < 0:
            raise ValueError("node ids must be non-negative")
        w = (
            np.ones(len(src), np.float32)
            if weight is None
            else np.asarray(weight, np.float32)
        )
        if (w < 0).any():
            raise ValueError("affinity weights must be non-negative")
        n = int(max(src.max(), dst.max())) + 1
        if n > _MAX_NODES:
            raise ValueError(
                f"{n} nodes exceeds the dense-affinity budget "
                f"({_MAX_NODES}); PIC here materializes (n, n) on the device"
            )
        a = _build_affinity(src, dst, w, n)
        deg = a.sum(axis=1)
        if (deg == 0).any():
            isolated = int(np.flatnonzero(deg == 0)[0])
            raise ValueError(
                f"node {isolated} has no edges; every node needs at least "
                "one affinity"
            )
        a /= deg[:, None]
        w_norm = torch.from_numpy(a).to(dev)
        del a

        rng = np.random.default_rng(self.seed)
        if self.init_mode == "degree":
            v0 = deg / deg.sum()
        else:
            v0 = rng.uniform(0, 1, size=n)
            v0 = v0 / np.abs(v0).sum()
        v0 = torch.from_numpy(np.asarray(v0, np.float32)).to(dev)
        return _power_iterate(w_norm, v0, self.max_iter).cpu().numpy().astype(np.float64)

    def assign_clusters(self, src, dst, weight=None, device=None) -> np.ndarray:
        """(n,) cluster id per node (node ids = 0..max id): the embedding,
        then k-means on it (Lin & Cohen step 3), both on ``device``
        (default the card)."""
        v = self.embed(src, dst, weight, device=device)
        from .kmeans import KMeans

        emb = v[:, None].astype(np.float32)
        km = KMeans(k=self.k, seed=self.seed, max_iter=40).fit(emb, device=device)
        return np.asarray(km.predict_numpy(emb, device=device)).astype(np.int64)


__all__ = ["PowerIterationClustering"]

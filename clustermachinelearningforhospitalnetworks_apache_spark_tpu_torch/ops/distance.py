"""Pairwise-distance primitives (the JAX package's ``ops/distance.py``).

``||x − c||² = ||x||² − 2·x·cᵀ + ||c||²``: the (n, k) distance matrix is
one float32 product plus rank-1 corrections, clamped at 0.  TF32 is off
(``device.py``), matching the reference's ``Precision.HIGHEST``.

These are the plain forms the K1/K2 kernels' plain versions are built
from (``ops/lloyd.py``); on the card the assignment itself runs in K2.
"""

from __future__ import annotations

import torch

#: rows per tile of the plain chunked assignment (``fused_assign_plain``)
#: — bounds the (chunk, k) tile
ASSIGN_CHUNK = 65536


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    return (x * x).sum(dim=-1)


def pairwise_sqdist(
    x: torch.Tensor,
    centers: torch.Tensor,
    x_sq: torch.Tensor | None = None,
    c_sq: torch.Tensor | None = None,
) -> torch.Tensor:
    """(n, d), (k, d) → (n, k) squared Euclidean distances (clamped ≥ 0)."""
    if x_sq is None:
        x_sq = sq_norms(x)
    if c_sq is None:
        c_sq = sq_norms(centers)
    d2 = x_sq[:, None] - 2.0 * (x @ centers.T) + c_sq[None, :]
    return torch.clamp(d2, min=0.0)


def assign_clusters(x: torch.Tensor, centers: torch.Tensor, c_sq=None):
    """→ (argmin index (n,) int32, min squared distance (n,))."""
    d2 = pairwise_sqdist(x, centers, c_sq=c_sq)
    m, a = d2.min(dim=1)
    return a.to(torch.int32), m

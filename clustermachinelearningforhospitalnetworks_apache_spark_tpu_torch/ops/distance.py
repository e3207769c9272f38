"""Pairwise-distance primitives (the JAX package's ``ops/distance.py``).

``||x − c||² = ||x||² − 2·x·cᵀ + ||c||²``: the (n, k) distance matrix is
one float32 product plus rank-1 corrections, clamped at 0.  TF32 is off
(``device.py``), matching the reference's ``Precision.HIGHEST``.

These are the plain forms the K1/K2 kernels' plain versions are built
from (``ops/lloyd.py``); on the card the assignment itself runs in K2
(:func:`assign_clusters_chunked`, shard by shard over a mesh).

:func:`matmul_p` is the reference's matmul under a precision mode, for
KMeans' and GaussianMixture's reduced-precision fits (XLA matmuls in the
JAX package, not Pallas kernels, so ``torch.matmul`` serves them):

- ``"highest"``: float32 (TF32 stays off, ``device.py``);
- ``"high"`` / ``"default"``: float32 on the CPU, as XLA on the CPU; on the
  card TF32, what XLA runs for these precisions on an NVIDIA GPU, turned on
  for the one product and restored after it, also when it raises;
- ``"bf16"``: both operands rounded to bfloat16, the products summed in
  float32, float32 out.  On the card one ``torch.mm(..., out_dtype=
  torch.float32)`` (cuBLAS on the tensor cores, bf16 in, float32 out); on
  the CPU the float32 product of the bf16-rounded operands, which means
  the same.
"""

from __future__ import annotations

import contextlib

import torch

#: matmul precision modes of the reduced-precision fits (the JAX package's
#: ``ops/distance.py``)
MATMUL_PRECISIONS = ("highest", "high", "default", "bf16")


def validate_matmul_precision(value: str) -> None:
    """Raise the reference's error for an unknown precision mode."""
    if value not in MATMUL_PRECISIONS:
        raise ValueError(
            f"matmul_precision must be one of {MATMUL_PRECISIONS}, got "
            f"{value!r}"
        )


@contextlib.contextmanager
def _tf32():
    """TF32 matmuls for the block, the flag restored after it."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def matmul_p(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """2-D ``a @ b`` in float32 under a :data:`MATMUL_PRECISIONS` mode."""
    if precision == "bf16":
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        if a.is_cuda:
            return torch.mm(a16, b16, out_dtype=torch.float32)
        return a16.to(torch.float32) @ b16.to(torch.float32)
    if precision != "highest" and a.is_cuda:
        with _tf32():
            return a @ b
    return a @ b

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
    precision: str = "highest",
) -> torch.Tensor:
    """(n, d), (k, d) → (n, k) squared Euclidean distances (clamped ≥ 0);
    the cross term under ``precision`` (:func:`matmul_p`)."""
    if x_sq is None:
        x_sq = sq_norms(x)
    if c_sq is None:
        c_sq = sq_norms(centers)
    d2 = x_sq[:, None] - 2.0 * matmul_p(x, centers.T, precision) + c_sq[None, :]
    return torch.clamp(d2, min=0.0)


def normalize_rows(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit-normalize rows: cosine distance is then Euclidean on the sphere
    (Spark's ``distanceMeasure="cosine"``)."""
    return x / torch.sqrt(torch.clamp(sq_norms(x), min=eps))[:, None]


def assign_clusters(x: torch.Tensor, centers: torch.Tensor, c_sq=None):
    """→ (argmin index (n,) int32, min squared distance (n,))."""
    d2 = pairwise_sqdist(x, centers, c_sq=c_sq)
    m, a = d2.min(dim=1)
    return a.to(torch.int32), m


def assign_clusters_chunked(x, centers: torch.Tensor, chunk: int = ASSIGN_CHUNK):
    """The assignment (argmin index, int32) with no (n, k) distance matrix:
    the K2 kernel on the card (its plain version, tiled by ASSIGN_CHUNK
    rows, on the CPU).  A row-sharded
    :class:`~..parallel.sharding.MeshArray` is assigned shard by shard on
    each shard's device, one K2 launch a shard, into a MeshArray (the
    reference's shard-local ``shard_map``).  ``chunk``, the reference's
    row tile, is accepted for the reference's signature and ignored: K2
    builds no (n, k) tile at any size, so there is no memory to bound."""
    from ..parallel.sharding import MeshArray
    from .lloyd import fused_assign

    if isinstance(x, MeshArray):
        return x.map_data(lambda b: assign_clusters_chunked(b, centers, chunk))
    c = centers.to(device=x.device, dtype=torch.float32).contiguous()
    c_valid = torch.ones((c.shape[0],), dtype=torch.float32, device=x.device)
    return fused_assign(x.to(torch.float32).contiguous(), c, c_valid)[0]

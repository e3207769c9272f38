"""Shared weighted column reductions (the JAX package's
``ops/reductions.py``).

One pass producing every per-column statistic ``ml.stat`` consumes: Σw,
the count of rows with w > 0, Σw·x, Σw·x², Σw·x xᵀ, the masked min and
max, the L1 norm and the w-weighted non-zero count.  The masked min/max
use the finite sentinel ±3.4e38, as the reference.  ``xtx`` is summed per
chunk of rows and then over the chunks (``linear_regression.
chunked_gram``), so its float32 sum stays near the reference's
per-device sums.  Σw·x accumulates in float64: a column mean is then the
same on every device, where two float32 sums of 2M rows in different
orders differ by as much as rounding the rows to bfloat16 moves them.

Rows laid over a mesh (``x`` and ``w`` row-sharded
:class:`~..parallel.sharding.MeshArray` s, the reference's sharded
arrays) take the pass once a data shard on its device; the sums (n,
count, s1, s2, xtx, l1, nnz) are added in ascending shard order
(``collectives.aggregate_shards``) and the extremes are the min / max of
the shards', so count, min, max and nnz (sums of integers) are the same
on every mesh shape.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.linear_regression import chunked_gram

#: finite sentinel for masked min/max (±inf would poison a sum-based pass)
MASK_BIG = float(np.float32(3.4e38))


#: the statistics summed over the shards (the rest are extremes)
_SUMS = ("n", "count", "s1", "s2", "xtx", "l1", "nnz")


def moment_stats(x, w) -> dict:
    """The statistics of weighted, padded rows (pad rows w = 0), on x's
    device; row-sharded MeshArrays give their shards' statistics
    combined on the home device (this process's first data shard's)."""
    from ..parallel.sharding import MeshArray

    if isinstance(x, MeshArray):
        return _sharded_moment_stats(x, w)
    x = x.to(torch.float32)
    w = w.to(torch.float32)
    wcol = w[:, None]
    valid = wcol > 0
    big = torch.full_like(x, MASK_BIG)
    return {
        "n": torch.sum(w),
        "count": torch.sum((w > 0).to(x.dtype)),
        "s1": torch.sum(x * wcol, dim=0, dtype=torch.float64),
        "s2": torch.sum(x * x * wcol, dim=0),
        "xtx": chunked_gram(x * wcol, x),
        "min": torch.min(torch.where(valid, x, big), dim=0).values,
        "max": torch.max(torch.where(valid, x, -big), dim=0).values,
        "l1": torch.sum(torch.abs(x) * wcol, dim=0),
        "nnz": torch.sum(((x != 0) & valid).to(x.dtype) * wcol, dim=0),
    }


def _sharded_moment_stats(x, w) -> dict:
    """``moment_stats`` a data shard, the sums added in ascending shard
    order and the extremes reduced over the shards' (one gather each
    under a process group)."""
    from ..parallel.collectives import aggregate_shards, gather_shards

    mesh = x.mesh
    per = {i: moment_stats(x.block(i), w.block(i)) for i in mesh.local_data_shards()}
    out = aggregate_shards(lambda i: {k: per[i][k] for k in _SUMS}, mesh)
    ext: list = [None] * mesh.devices.shape[0]
    for i, s in per.items():
        ext[i] = torch.stack([s["min"], s["max"]])
    ext = torch.stack([e.to(out["n"].device) for e in gather_shards(ext, mesh)])
    out["min"] = ext[:, 0].min(dim=0).values
    out["max"] = ext[:, 1].max(dim=0).values
    return out


def host_moments(x, w) -> dict:
    """``moment_stats`` on the host as float64, read in one copy."""
    s = moment_stats(x, w)
    flat = torch.cat([v.reshape(-1) for v in s.values()]).cpu().numpy().astype(np.float64)
    out, at = {}, 0
    for k, v in s.items():
        out[k] = flat[at:at + v.numel()].reshape(v.shape)
        at += v.numel()
    return {k: (v[()] if v.ndim == 0 else v) for k, v in out.items()}


__all__ = ["MASK_BIG", "host_moments", "moment_stats"]

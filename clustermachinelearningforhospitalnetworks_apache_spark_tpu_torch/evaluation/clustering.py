"""ClusteringEvaluator — the squared-Euclidean silhouette in O(n·k).

The JAX package's ``evaluation/clustering.py`` formulation (Spark's):

    Σ_{q∈C} ||p−q||² = N_C·||p||² − 2·p·Y_C + Ψ_C,
    with Y_C = Σ_{q∈C} q  and  Ψ_C = Σ_{q∈C} ||q||².

Pass 1 accumulates the weighted (N_C, Y_C, Ψ_C) as one-hot products a
chunk of rows, summed in chunk order (the same bits run after run on the
card, where a scatter's float atomics are not); pass 2 scores rows in
chunks against them, so no (n, n) or (n, k) tensor is ever built.  a(p)
divides by N_C−1 (self excluded), b(p) is the min over other non-empty
clusters dividing by N_C, s(p) = (b−a)/max(a,b); singleton clusters score
0.  Runs on the device the features lie on.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..data import DeviceDataset, device_dataset
from ..device import resolve_device

#: bound on the floats of one (chunk, k) tile of pass 2
_SIL_TILE = 1 << 24
#: rows a chunk of pass 1: the (chunk, k) one-hot of k = 256 is 64 MiB
_SIL_CHUNK = 1 << 16


def _cluster_stats(x, assign, w, k: int):
    """Pass 1: (idx, w masked to in-range assignments, |x|², the per-cluster
    (N_C, Y_C, Ψ_C) packed as one (k·(d + 2),) vector).  The sums are the
    reference's one-hot products, ``onehot(idx)ᵀ·[x | 1 | |x|²]`` weighted,
    one a chunk of :data:`_SIL_CHUNK` rows, added in chunk order: no
    scatter, so the order of the sum is fixed on every device."""
    in_range = (assign >= 0) & (assign < k)
    w = torch.where(in_range, w, torch.zeros_like(w))
    idx = torch.where(in_range, assign, torch.zeros_like(assign)).to(torch.int64)
    sq = (x * x).sum(dim=1)
    d = x.shape[1]
    cells = torch.arange(k, device=x.device)
    sums = torch.zeros((k, d + 2), dtype=x.dtype, device=x.device)
    for s in range(0, x.shape[0], _SIL_CHUNK):
        e = s + _SIL_CHUNK
        oh = (idx[s:e, None] == cells[None, :]).to(x.dtype) * w[s:e, None]
        rhs = torch.cat([x[s:e], torch.ones_like(sq[s:e, None]), sq[s:e, None]], dim=1)
        sums = sums + oh.T @ rhs
    return idx, w, sq, torch.cat([sums[:, d], sums[:, :d].reshape(-1), sums[:, d + 1]])


def _score(x, idx, w, sq, packed, k: int) -> torch.Tensor:
    """Pass 2 against the global (N_C, Y_C, Ψ_C): → float64 [Σ s·w, Σ w]."""
    d = x.shape[1]
    counts, y, psi = packed[:k], packed[k : k + k * d].view(k, d), packed[k + k * d :]
    empty = counts == 0
    safe_counts = torch.clamp(counts, min=1.0)
    s_sum = torch.zeros((), dtype=torch.float64, device=x.device)
    step = max(1, _SIL_TILE // k)
    for s in range(0, x.shape[0], step):
        xc, ic, wc, sqc = x[s : s + step], idx[s : s + step], w[s : s + step], sq[s : s + step]
        tot = counts[None, :] * sqc[:, None] - 2.0 * (xc @ y.T) + psi[None, :]
        tot = torch.clamp(tot, min=0.0)
        n_own = counts[ic]
        a = tot.gather(1, ic[:, None])[:, 0] / torch.clamp(n_own - 1.0, min=1.0)
        own = torch.zeros_like(tot, dtype=torch.bool).scatter_(1, ic[:, None], True)
        b = torch.where(own | empty[None, :], torch.full_like(tot, float("inf")),
                        tot / safe_counts[None, :]).min(dim=1).values
        sc = torch.where(
            n_own > 1.0, (b - a) / torch.clamp(torch.maximum(a, b), min=1e-30),
            torch.zeros_like(a),
        )
        sc = torch.where(torch.isfinite(sc), sc, torch.zeros_like(sc))
        s_sum += (sc * wc).sum().to(torch.float64)
    return torch.stack([s_sum, w.sum(dtype=torch.float64)])


def _silhouette(x, assign, w, k: int):
    """(x, assign, w) → (Σ s·w, Σ w), both float64 host scalars."""
    idx, w, sq, packed = _cluster_stats(x, assign, w, k)
    out = _score(x, idx, w, sq, packed, k)
    return float(out[0]), float(out[1])


def _silhouette_sharded(sds, assign, k: int):
    """The two passes shard by shard, each shard's statistics and scores
    summed in ascending shard order (``parallel.collectives``)."""
    from ..parallel.collectives import ordered_sum

    mesh, passes = sds.mesh, {}
    packed: list = [None] * len(sds.shards)
    for i, s in enumerate(sds.shards):
        if s is not None:
            x = s.x.to(torch.float32)
            passes[i] = (x,) + _cluster_stats(x, assign.block(i).to(torch.int32),
                                              s.w.to(torch.float32), k)
            packed[i] = passes[i][-1]
    total = ordered_sum(packed, mesh)
    scores: list = [None] * len(sds.shards)
    for i, (x, idx, w, sq, _) in passes.items():
        scores[i] = _score(x, idx, w, sq, total.to(x.device), k)
    out = ordered_sum(scores, mesh)
    return float(out[0]), float(out[1])


def inertia(x: torch.Tensor, centers: torch.Tensor, assign: torch.Tensor,
            w: torch.Tensor) -> torch.Tensor:
    """The weighted within-cluster sum of squared distances (KMeans'
    ``trainingCost``), as a 0-d tensor on x's device."""
    d = x - centers[assign.to(torch.int64)]
    return torch.sum(torch.sum(d * d, dim=1) * w)


@dataclass(frozen=True)
class ClusteringEvaluator:
    """metricName="silhouette", distanceMeasure="squaredEuclidean"."""

    metric_name: str = "silhouette"

    @property
    def is_larger_better(self) -> bool:
        """Spark's ``isLargerBetter``: silhouette is."""
        return True

    def evaluate(self, features, assignments, k: int | None = None,
                 device=None, mesh=None) -> float:
        """``features``: the dataset a model was fit on (a DeviceDataset,
        a ShardedDataset or a FederatedDataset, with assignments from
        ``model.predict(ds.x)``) or host rows, moved to ``device``
        (default the card) or laid over ``mesh``.  Host assignments follow
        the rows' order (a federated layout scatters them by its
        ``row_order``)."""
        from ..parallel.federation import FederatedDataset
        from ..parallel.sharding import MeshArray, ShardedDataset, shard_rows
        from ..parallel.sharding import device_dataset as mesh_dataset

        if self.metric_name != "silhouette":
            raise ValueError(f"unsupported metric {self.metric_name!r}")
        row_order = None
        if isinstance(features, FederatedDataset):
            row_order = features.row_order
            features = features.data
        if isinstance(features, (DeviceDataset, ShardedDataset)):
            ds = features
        elif mesh is not None:
            ds = mesh_dataset(np.asarray(features), mesh=mesh)
        else:
            ds = device_dataset(np.asarray(features), device=resolve_device(device))
        n_pad = ds.n_padded

        def to_slots(values):
            v = np.asarray(values).astype(np.int32).reshape(-1)
            out = np.zeros((n_pad,), dtype=np.int32)
            if row_order is None:
                out[: v.shape[0]] = v
            else:
                live = row_order >= 0
                out[live] = v[row_order[live]]
            return out

        if isinstance(ds, ShardedDataset):
            if not (isinstance(assignments, MeshArray) and assignments.shape[0] == n_pad):
                if isinstance(assignments, torch.Tensor):
                    assignments = assignments.cpu().numpy()
                assignments = shard_rows(to_slots(assignments), ds.mesh)
            if k is None:
                k = int(np.where(ds.w.numpy() > 0, assignments.numpy(), 0).max()) + 1
            s_sum, n = _silhouette_sharded(ds, assignments, int(k))
            return s_sum / max(n, 1.0)
        dev = ds.x.device
        if isinstance(assignments, torch.Tensor) and assignments.shape[0] == n_pad:
            assign = assignments.to(dev, torch.int32)
        else:
            assign = torch.from_numpy(to_slots(
                assignments.cpu().numpy() if isinstance(assignments, torch.Tensor)
                else assignments)).to(dev)
        w = ds.w
        if k is None:
            k = int(torch.where(w > 0, assign, torch.zeros_like(assign)).max()) + 1
        s_sum, n = _silhouette(ds.x.to(torch.float32), assign,
                               w.to(torch.float32), int(k))
        return s_sum / max(n, 1.0)

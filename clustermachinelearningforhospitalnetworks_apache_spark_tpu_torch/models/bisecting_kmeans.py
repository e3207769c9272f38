"""BisectingKMeans — hierarchical divisive clustering (BASELINE config 4),
the JAX package's ``models/bisecting_kmeans.py`` on one CUDA device,
in-core and Euclidean.

Spark's ``BisectingKMeans`` (k, maxIter, seed, minDivisibleClusterSize)
grows the tree level by level, larger clusters first when splitting every
divisible leaf would overshoot k.  The fit here is the JAX package's level
algorithm as a host loop over levels with torch ops inside:

- the schedule — divisibility, the k budget, the priority (sizes for
  ``strategy="level"``, SSE for ``"sequential"``, one split a level) —
  runs on the host over the k-slot leaf state, as the JAX package's
  out-of-core fit does;
- children are seeded at parent ± half an RMS-radius step in a direction
  drawn by ``prng.normal`` under ``fold_in(key, level)``;
- the constrained 2-means Lloyd loop runs on the device over all rows at
  once: each row competes only between its own leaf's two children
  (ranked by |c|² − 2x·c), until no center moves more than 1e-8 or after
  ``max_iter`` iterations; a final pass gives the true child sizes, SSE
  and each row's side, and the rows' leaf ids are relabelled on the
  device.

All cluster math runs on rows recentered around the global mean (the
float32 cancellation argument of the JAX package); ``n_restarts`` whole
trees are grown and the lowest final cost wins; empty leaves are compacted
away.  The host syncs once a Lloyd iteration (its move), once a level (the
children's sizes and SSE) and once a tree (the root); the JAX package
makes one a tree.  ``model.fit_info`` counts them.

The model is a :class:`KMeansModel`, so ``predict`` is the K2 kernel on
the card.  ``distance_measure="cosine"``, ``weight_col`` and the
out-of-core ``HostDataset`` input come with slice 4c of the port (they
raise).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import prng
from ..io.model_io import register_model
from .base import Estimator, as_device_dataset
from .kmeans import KMeansModel

_BIG = 1e30
_SLICE_4C = "slice 4c of the port"


def _children_d2(xs, cen, pos, exact: bool):
    """(n, 2L) distances of each row to the children, +BIG outside its
    own leaf's pair: |c|² − 2x·c (ranking only) or the true clamped d²."""
    c_sq = (cen * cen).sum(dim=1)
    cross = xs @ cen.T
    if exact:
        d2 = torch.clamp((xs * xs).sum(dim=1)[:, None] - 2.0 * cross + c_sq[None, :], min=0.0)
    else:
        d2 = c_sq[None, :] - 2.0 * cross
    child_leaf = torch.arange(cen.shape[0], device=xs.device) // 2
    return torch.where(child_leaf[None, :] == pos[:, None], d2, torch.full_like(d2, _BIG))


def _lloyd_pass(xs, wv, pos, cen):
    """One constrained 2-means iteration's child (sums, counts)."""
    arg = torch.argmin(_children_d2(xs, cen, pos, exact=False), dim=1)
    sums = torch.zeros_like(cen).index_add_(0, arg, xs * wv[:, None])
    counts = torch.zeros((cen.shape[0],), dtype=xs.dtype, device=xs.device)
    return sums, counts.index_add_(0, arg, wv)


def _stats_pass(xs, wv, pos, cen):
    """Final pass on converged children: (counts, SSE, each row's side)."""
    d2 = _children_d2(xs, cen, pos, exact=True)
    mind, arg = d2.min(dim=1)
    mind = torch.clamp(mind, min=0.0)
    zero = torch.zeros((cen.shape[0],), dtype=xs.dtype, device=xs.device)
    counts = zero.clone().index_add_(0, arg, wv)
    sse = zero.index_add_(0, arg, wv * torch.where(wv > 0, mind, torch.zeros_like(mind)))
    return counts, sse, (arg % 2).to(torch.int32)


@register_model("BisectingKMeansModel")
@dataclass
class BisectingKMeansModel(KMeansModel):
    def _artifacts(self):
        _, meta, arrays = super()._artifacts()
        return ("BisectingKMeansModel", meta, arrays)


@dataclass(frozen=True)
class BisectingKMeans(Estimator):
    k: int = 4
    max_iter: int = 20                    # Lloyd iterations a level (Spark default)
    seed: int = 0
    min_divisible_cluster_size: float = 1.0  # rows (>= 1) or fraction (< 1)
    distance_measure: str = "euclidean"
    #: "level" (Spark: every divisible leaf of a level splits, larger
    #: clusters first) or "sequential" (one largest-SSE split a level)
    strategy: str = "level"
    weight_col: str | None = None
    #: best of n whole trees (restart r seeds from fold_in(key, r), r = 0
    #: from the key itself); the lowest final cost wins
    n_restarts: int = 4

    def fit(self, data, label_col: str | None = None, mesh=None,
            device=None) -> BisectingKMeansModel:
        """Fit on ``data`` (DeviceDataset, AssembledTable, (x, y[, w]) or
        x) on ``device`` (default the card)."""
        if self.distance_measure != "euclidean":
            raise NotImplementedError(
                f"distance_measure={self.distance_measure!r} comes with {_SLICE_4C}; "
                "the port fits euclidean BisectingKMeans")
        if self.weight_col is not None:
            raise NotImplementedError(f"BisectingKMeans weight_col= comes with {_SLICE_4C}")
        if type(data).__name__ == "HostDataset":
            raise NotImplementedError(f"the out-of-core BisectingKMeans fit comes with {_SLICE_4C}")
        if self.strategy not in ("level", "sequential"):
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.n_restarts < 1:
            raise ValueError(f"n_restarts must be >= 1, got {self.n_restarts}")
        ds = as_device_dataset(data, device=device)
        x = ds.x.to(torch.float32)
        w = ds.w.to(torch.float32)
        f32 = np.float32

        # the root leaf: weighted mean (the recentering shift), then SSE
        s0_t = w.sum()
        mean_t = (w @ x) / torch.clamp(s0_t, min=1.0)
        xs = x - mean_t[None, :]
        root_sse_t = ((xs * xs).sum(dim=1) * w).sum()
        s0, root_sse = (float(v) for v in torch.stack([s0_t, root_sse_t]).cpu())
        shift = mean_t.cpu().numpy()
        if s0 == 0.0:
            raise ValueError("BisectingKMeans fit on an empty dataset")
        min_div = f32(self.min_divisible_cluster_size)
        min_size = max(min_div * f32(s0) if self.min_divisible_cluster_size < 1.0 else min_div,
                       f32(2.0))

        sequential = self.strategy == "sequential"
        # at most ⌊k/2⌋ leaves split in one level; L is a power of two, as
        # in the JAX package (sequential: one leaf a level)
        L = 1 if sequential else 1 << (max(1, self.k // 2) - 1).bit_length()
        base_key = prng.key(self.seed)
        info = {"trees": self.n_restarts, "levels": [], "lloyd_iters": 0, "host_syncs": 1}
        best = None
        for r in range(self.n_restarts):
            key_r = base_key if r == 0 else prng.fold_in(base_key, r)
            out = self._grow_tree(xs, w, key_r, L, f32(s0), f32(root_sse), min_size,
                                  sequential, info)
            if best is None or out[0] < best[0]:
                best = out
        _, centers, sizes, sse, n_splits = best
        keep = np.flatnonzero(sizes[: self.k] > 0)
        model = BisectingKMeansModel(
            cluster_centers=(centers[: self.k] + shift[None, :])[keep].astype(np.float32),
            distance_measure=self.distance_measure,
            training_cost=float(sse[: self.k][keep].sum()),
            n_iter=int(n_splits),
            cluster_sizes=sizes[: self.k][keep],
        )
        model.fit_info = info
        return model

    def _grow_tree(self, xs, w, key, L, s0, root_sse, min_size, sequential, info):
        """One complete split tree → (cost, centers, sizes, sse, n_splits);
        the leaf state has k + 1 slots, slot k a write-only dummy."""
        k, d, dev = self.k, xs.shape[1], xs.device
        centers = np.zeros((k + 1, d), np.float32)      # root = mean − shift = 0
        sizes = np.zeros((k + 1,), np.float32)
        sizes[0] = s0
        sse = np.zeros((k + 1,), np.float32)
        sse[0] = root_sse
        divisible = np.zeros((k + 1,), bool)
        divisible[0] = True
        assign = torch.zeros((xs.shape[0],), dtype=torch.int64, device=dev)
        tol_sq = np.float32(1e-8)
        n_leaves, n_splits, level = 1, 0, 0
        while n_leaves < k:
            cand = divisible[:k] & (sizes[:k] >= min_size)
            if not cand.any():
                break
            priority = sse[:k] if sequential else sizes[:k]
            order = np.argsort(-np.where(cand, priority, np.float32(-1.0)), kind="stable")
            sel = order[:L]
            slot_valid = (np.arange(L) < (k - n_leaves)) & cand[sel]
            slot_of = np.full((k + 1,), -1, np.int64)
            slot_of[sel] = np.where(slot_valid, np.arange(L), -1)
            # seed the children: parent ± half an RMS-radius step
            radius = np.sqrt(np.maximum(sse[sel], np.float32(1e-12))
                             / np.maximum(sizes[sel], np.float32(1.0)))
            dirs = prng.normal(prng.fold_in(key, level), (L, d)).numpy()
            dirs = dirs / np.maximum(np.sqrt((dirs * dirs).sum(axis=1, keepdims=True)),
                                     np.float32(1e-12)) * radius[:, None]
            parents = centers[sel]
            cen = torch.from_numpy(np.stack([parents + np.float32(0.5) * dirs,
                                             parents - np.float32(0.5) * dirs],
                                            axis=1).reshape(2 * L, d)).to(dev)
            pos = torch.from_numpy(slot_of).to(dev)[assign]
            pos = torch.where(w > 0, pos, torch.full_like(pos, -1))
            wv = torch.where(pos >= 0, w, torch.zeros_like(w))
            valid2 = torch.from_numpy(np.repeat(slot_valid, 2).astype(np.float32)).to(dev)

            # the constrained 2-means Lloyd loop over every splitting leaf
            it, move = 0, np.float32(np.inf)
            while it < self.max_iter and move > tol_sq:
                sums, counts = _lloyd_pass(xs, wv, pos, cen)
                new_cen = torch.where((counts > 0)[:, None],
                                      sums / torch.clamp(counts, min=1.0)[:, None], cen)
                move = np.float32((((new_cen - cen) ** 2).sum(dim=1) * valid2).max().item())
                cen = new_cen
                it += 1
            counts, csse, bits = _stats_pass(xs, wv, pos, cen)
            counts2, csse2 = (a.reshape(L, 2) for a in
                              torch.stack([counts, csse]).cpu().numpy())
            cen2 = cen.cpu().numpy().reshape(L, 2, d)
            info["lloyd_iters"] += it
            info["host_syncs"] += it + 1
            info["levels"].append(it)

            # bookkeeping: a split succeeds iff the new child got rows
            succ = slot_valid & (counts2[:, 1] > 0)
            new_id = np.where(succ, n_leaves + np.cumsum(succ) - 1, k)
            safe_p = torch.clamp(pos, 0, L - 1)
            relabel = (pos >= 0) & (bits == 1) & torch.from_numpy(succ).to(dev)[safe_p]
            assign = torch.where(relabel, torch.from_numpy(new_id).to(dev)[safe_p], assign)

            centers[sel] = np.where(succ[:, None], cen2[:, 0], centers[sel])
            sizes[sel] = np.where(succ, counts2[:, 0], sizes[sel])
            sse[sel] = np.where(succ, csse2[:, 0], sse[sel])
            # the parent stays divisible iff it kept rows; a failed split
            # (the new child empty) pins the leaf closed
            divisible[sel] = np.where(slot_valid, succ & (counts2[:, 0] > 0), divisible[sel])
            centers[new_id] = np.where(succ[:, None], cen2[:, 1], centers[new_id])
            sizes[new_id] = np.where(succ, counts2[:, 1], sizes[new_id])
            sse[new_id] = np.where(succ, csse2[:, 1], sse[new_id])
            divisible[new_id] = np.where(succ, True, divisible[new_id])
            grown = int(succ.sum())
            n_leaves += grown
            n_splits += grown
            level += 1
        cost = float(sse[:k][sizes[:k] > 0].sum())
        return cost, centers, sizes, sse, n_splits

"""BisectingKMeans — hierarchical divisive clustering (BASELINE config 4),
the JAX package's ``models/bisecting_kmeans.py`` on one CUDA device.

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

The resident passes rank the children and sum the rows in float64 over
float32 rows and centers (a product of two float32 numbers is exact
there), then round the sums to float32: a fit decides its near-tie rows
and rounds its centers alike on the card and on the CPU, with one-hot
products summed per chunk of rows as the reference's scan sums them.
Centers, sizes and SSE stay float32, as in the reference.

All Euclidean cluster math runs on rows recentered around the global
mean (the float32 cancellation argument of the JAX package);
``distance_measure="cosine"`` trains on unit rows (pad rows zeroed by the
0/1 mask) with no shift, the root and every child center renormalized, so
the Euclidean argmin on the sphere orders by cosine distance.
``weight_col`` weights every statistic.  ``n_restarts`` whole trees are
grown and the lowest final cost wins; empty leaves are compacted away.
The host syncs once a Lloyd iteration (its move), once a level (the
children's sizes and SSE) and once a tree (the root); the JAX package
makes one a tree.  ``model.fit_info`` counts them, and its ``splits``
lists the winning tree's splits as ``[level, parent slot, new slot]``
(leaf slots before empty leaves are compacted away).

Over a mesh (``fit(..., mesh=)``, or a ``ShardedDataset``) the resident
fit runs over the data axis, as the reference's ``_lloyd_scan`` /
``_stats_scan`` psums do: each data shard keeps its rows and their leaf
ids on its device (``base.Shards``; the model axis is replicated, the
reference shards only ``DATA_AXIS``), the root's sums, every Lloyd pass's
float64 child sums and counts and each level's counts and SSE are computed
a shard on that shard's device and summed in ascending shard order
(``collectives.aggregate_shards``), and the schedule, the stop rule and the
restarts run once on the home device and the host.  One device is one
shard and keeps its bits; a sharded fit equals it where the float32 root
sums are exact (integer rows), and within rounding elsewhere.

A :class:`~..parallel.outofcore.HostDataset` takes the reference's
out-of-core fit, on one device or over a mesh (``fit(HostDataset,
mesh=)``): the per-row leaf lives on the host, every Lloyd iteration and
every level's stats pass is a sweep over the streamed blocks
(:func:`_bkm_lloyd_block`, :func:`_bkm_stats_block` once a data shard of
a block), children are seeded from the same ``fold_in(key, level)`` draws
and restarts, so both routes walk the same split tree up to rounding.
Each row takes the nearer child of its leaf's pair in float32, as in the
reference; the root's moments and the child sums, counts and SSE are
float64 a shard, summed over the block's shards in ascending order and
over the blocks in float64 and rounded to float32 once on the host, so
the split tree hardly depends on the mesh shape or the block size (the
model axis is replicated, as in the reference).

The model is a :class:`KMeansModel`, so ``predict`` is the K2 kernel on
the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import prng
from ..io.model_io import register_model
from ..parallel.outofcore import (HostDataset, add_stats, shard_rows, shard_sum, stream_home,
                                  stream_mesh)
from .base import Estimator, Shards, on_mesh
from .kmeans import KMeansModel, _cosine_prep, normalize_rows
from .linear_regression import chunked_gram

_BIG = 1e30


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


def _weighted_onehot(arg, k2: int, wv):
    return torch.nn.functional.one_hot(arg, k2).to(wv.dtype) * wv[:, None]


def _lloyd_pass(xs, wv, pos, cen):
    """One constrained 2-means iteration's float64 child (sums, counts) on
    a shard's rows (rounded to float32 once the shards are summed).
    ``xs`` and ``wv`` are float64 (module docstring): one-hot products
    summed per chunk of rows, as the reference's scan does."""
    arg = torch.argmin(_children_d2(xs, cen.to(xs.dtype), pos, exact=False), dim=1)
    oh = _weighted_onehot(arg, cen.shape[0], wv)
    return chunked_gram(oh, xs), oh.sum(dim=0)


def _stats_pass(xs, wv, pos, cen):
    """Final pass on converged children, on a shard's rows: float64
    (counts, SSE) and each row's side."""
    d2 = _children_d2(xs, cen.to(xs.dtype), pos, exact=True)
    mind, arg = d2.min(dim=1)
    mind = torch.clamp(mind, min=0.0)
    oh = _weighted_onehot(arg, cen.shape[0], wv)
    sse = chunked_gram(oh, torch.where(wv > 0, mind, torch.zeros_like(mind)))
    return oh.sum(dim=0), sse, (arg % 2).to(torch.int32)


def _block_children(x, pos, cen, shift):
    """A streamed block's rows (shifted) and each row's nearer child of its
    leaf's pair in ``cen`` (2L, d), by direct squared differences: →
    (xb, child, d0, d1, bit)."""
    L = cen.shape[0] // 2
    xb = x.to(torch.float32) - shift[None, :]
    safe = torch.clamp(pos, 0, L - 1).to(torch.int64)
    d0 = ((xb - cen[2 * safe]) ** 2).sum(dim=1)
    d1 = ((xb - cen[2 * safe + 1]) ** 2).sum(dim=1)
    bit = (d1 < d0).to(torch.int64)
    return xb, 2 * safe + bit, d0, d1, bit


def _live_weights(pos, w):
    return ((pos >= 0) & (w > 0)).to(torch.float32) * w


def _block_onehot(child, pos, w, k2: int):
    return torch.nn.functional.one_hot(child, k2).to(torch.float64) * \
        _live_weights(pos, w).to(torch.float64)[:, None]


def _root_moments(x, w):
    """A shard's float64 (Σw, Σw·x) of its valid rows (pad rows' features
    masked before the product)."""
    w64 = w.to(torch.float64)
    x64 = torch.where(w[:, None] > 0, x, torch.zeros_like(x)).to(torch.float64)
    return w64.sum(), w64 @ x64


def _bkm_lloyd_block(x, w, pos, cen, shift):
    """One block shard's float64 2-means statistics (sums (2L, d), counts
    (2L,)) for every splitting leaf at once: a row of leaf slot ``pos``
    (−1: not splitting) takes the nearer of its leaf's two children.
    Euclidean on (for cosine, unit) rows serves both measures."""
    xb, child, _, _, _ = _block_children(x, pos, cen, shift)
    oh = _block_onehot(child, pos, w, cen.shape[0])
    return oh.T @ xb.to(torch.float64), oh.sum(dim=0)


def _bkm_stats_block(x, w, pos, cen, shift):
    """A level's last pass over a block shard: float64 child (counts, SSE)
    and each row's side bit."""
    _, child, d0, d1, bit = _block_children(x, pos, cen, shift)
    oh = _block_onehot(child, pos, w, cen.shape[0])
    mind = torch.where(bit == 1, d1, d0).to(torch.float64)
    return oh.sum(dim=0), (oh * mind[:, None]).sum(dim=0), bit.to(torch.int32)


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

    #: ``fit`` runs over a mesh of more than one shard (its resident path)
    mesh_fit = True

    def fit(self, data, label_col: str | None = None, mesh=None,
            device=None) -> BisectingKMeansModel:
        """Fit on ``data`` (DeviceDataset, ShardedDataset, AssembledTable,
        (x, y[, w]) or x) on ``device`` (default the card) or over ``mesh``
        (module docstring); a :class:`HostDataset` streams its blocks
        there."""
        if self.strategy not in ("level", "sequential"):
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.n_restarts < 1:
            raise ValueError(f"n_restarts must be >= 1, got {self.n_restarts}")
        if isinstance(data, HostDataset):
            return self._fit_outofcore(data, stream_mesh(mesh, device))
        sh = Shards(on_mesh(data, None, device, self.weight_col, mesh))
        x = {i: s.x.to(torch.float32) for i, s in sh.data.items()}
        w = {i: s.w.to(torch.float32) for i, s in sh.data.items()}
        cosine = self.distance_measure == "cosine"
        if cosine:
            # train in the geometry predict uses: the unit sphere
            x = {i: _cosine_prep(x[i], w[i]) for i in sh.local}
        f32 = np.float32

        # the root leaf: weighted mean (the recentering shift; none on the
        # sphere, where the root is the normalized mean), then its SSE
        s0_t, wx_t = sh.sum(lambda i, s: (w[i].sum(), w[i] @ x[i]))
        mean_t = wx_t / torch.clamp(s0_t, min=1.0)
        if cosine:
            shift_t = torch.zeros_like(mean_t)
            root_t = mean_t / torch.clamp(torch.linalg.norm(mean_t), min=1e-12)
        else:
            shift_t, root_t = mean_t, torch.zeros_like(mean_t)
        shift_s, root_s = sh.put(shift_t), sh.put(root_t)
        xs = {i: x[i] - shift_s[i][None, :] for i in sh.local}
        del x

        def sse(i, s):
            diff = xs[i] - root_s[i][None, :]
            return (((diff * diff).sum(dim=1) * w[i]).sum(),)

        root_sse_t, = sh.sum(sse)
        s0, root_sse = (float(v) for v in torch.stack([s0_t, root_sse_t]).cpu())
        shift = shift_t.cpu().numpy()
        root = root_t.cpu().numpy()
        if s0 == 0.0:
            raise ValueError("BisectingKMeans fit on an empty dataset")
        min_size = self._min_size(s0)

        L = self._leaves_a_level()
        info = {"trees": self.n_restarts, "levels": [], "lloyd_iters": 0, "host_syncs": 1}

        # the Lloyd passes in float64 (module docstring)
        xs64 = {i: xs[i].to(torch.float64) for i in sh.local}
        w64 = {i: w[i].to(torch.float64) for i in sh.local}
        del xs

        def grow(key):
            return self._grow_tree(sh, xs64, w64, key, L, root, f32(s0), f32(root_sse),
                                   min_size, cosine, info)

        return self._best_tree(grow, shift, info)

    def _min_size(self, s0: float):
        """Spark's minDivisibleClusterSize: rows (≥ 1) or a fraction of the
        weight (< 1), at least 2."""
        f32 = np.float32
        min_div = f32(self.min_divisible_cluster_size)
        return max(min_div * f32(s0) if self.min_divisible_cluster_size < 1.0 else min_div,
                   f32(2.0))

    def _leaves_a_level(self) -> int:
        """At most ⌊k/2⌋ leaves split in one level; L is a power of two, as
        in the JAX package (sequential: one leaf a level)."""
        if self.strategy == "sequential":
            return 1
        return 1 << (max(1, self.k // 2) - 1).bit_length()

    def _best_tree(self, grow, shift: np.ndarray, info: dict) -> BisectingKMeansModel:
        """``n_restarts`` whole trees (restart r from fold_in(key, r), r = 0
        from the key) → the model of the lowest final cost, empty leaves
        compacted away."""
        base_key = prng.key(self.seed)
        best = None
        for r in range(self.n_restarts):
            out = grow(base_key if r == 0 else prng.fold_in(base_key, r))
            if best is None or out[0] < best[0]:
                best = out
        _, centers, sizes, sse, n_splits, splits = best
        info["splits"] = splits
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

    def _schedule(self, centers, sizes, sse, divisible, n_leaves: int, min_size, L: int,
                  key, level: int, cosine: bool):
        """A level's split schedule and seeds, on the host: the leaves to
        split (the priority: sizes for "level", SSE for "sequential"), each
        leaf's slot, and the children at parent ± half an RMS-radius step
        in a direction drawn by ``prng.normal(fold_in(key, level))`` (unit
        rows in cosine mode).  → (sel, slot_valid, slot_of, cen (2L, d))
        or None when no leaf is divisible."""
        k, d = self.k, centers.shape[1]
        cand = divisible[:k] & (sizes[:k] >= min_size)
        if not cand.any():
            return None
        priority = sse[:k] if self.strategy == "sequential" else sizes[:k]
        order = np.argsort(-np.where(cand, priority, np.float32(-1.0)), kind="stable")
        sel = order[:L]
        slot_valid = (np.arange(L) < (k - n_leaves)) & cand[sel]
        slot_of = np.full((k + 1,), -1, np.int64)
        slot_of[sel] = np.where(slot_valid, np.arange(L), -1)
        radius = np.sqrt(np.maximum(sse[sel], np.float32(1e-12))
                         / np.maximum(sizes[sel], np.float32(1.0)))
        dirs = prng.normal(prng.fold_in(key, level), (L, d)).numpy()
        dirs = dirs / np.maximum(np.sqrt((dirs * dirs).sum(axis=1, keepdims=True)),
                                 np.float32(1e-12)) * radius[:, None]
        parents = centers[sel]
        cen = np.stack([parents + np.float32(0.5) * dirs, parents - np.float32(0.5) * dirs],
                       axis=1).reshape(2 * L, d)
        if cosine:
            cen = normalize_rows(torch.from_numpy(cen)).numpy()
        return sel, slot_valid, slot_of, cen

    def _record_level(self, centers, sizes, sse, divisible, splits: list, level: int,
                      n_leaves: int, sel, slot_valid, counts2, csse2, cen2):
        """The level's bookkeeping, in place on the host leaf state
        (centers, sizes, sse, divisible, the split log): a split succeeds
        iff its new child got rows; the parent stays divisible iff it kept
        rows (a failed split pins the leaf closed).  → (succ, new_id,
        grown)."""
        k = self.k
        succ = slot_valid & (counts2[:, 1] > 0)
        new_id = np.where(succ, n_leaves + np.cumsum(succ) - 1, k)
        centers[sel] = np.where(succ[:, None], cen2[:, 0], centers[sel])
        sizes[sel] = np.where(succ, counts2[:, 0], sizes[sel])
        sse[sel] = np.where(succ, csse2[:, 0], sse[sel])
        divisible[sel] = np.where(slot_valid, succ & (counts2[:, 0] > 0), divisible[sel])
        centers[new_id] = np.where(succ[:, None], cen2[:, 1], centers[new_id])
        sizes[new_id] = np.where(succ, counts2[:, 1], sizes[new_id])
        sse[new_id] = np.where(succ, csse2[:, 1], sse[new_id])
        divisible[new_id] = np.where(succ, True, divisible[new_id])
        splits.extend([level, int(p), int(c)] for p, c in zip(sel[succ], new_id[succ]))
        return succ, new_id, int(succ.sum())

    def _grow_tree(self, sh: Shards, xs: dict, w: dict, key, L, root, s0, root_sse, min_size,
                   cosine, info):
        """One complete split tree over the data shards of ``sh`` (``xs`` /
        ``w`` a shard's float64 rows and weights on its device) →
        (cost, centers, sizes, sse, n_splits, splits); the leaf state has
        k + 1 slots, slot k a write-only dummy."""
        k, d, home = self.k, root.shape[0], sh.home
        centers = np.zeros((k + 1, d), np.float32)
        centers[0] = root                    # mean − shift (0), or the unit mean
        sizes = np.zeros((k + 1,), np.float32)
        sizes[0] = s0
        sse = np.zeros((k + 1,), np.float32)
        sse[0] = root_sse
        divisible = np.zeros((k + 1,), bool)
        divisible[0] = True
        # each row's leaf, on its shard
        assign = {i: torch.zeros((xs[i].shape[0],), dtype=torch.int64, device=sh.device(i))
                  for i in sh.local}
        tol_sq = np.float32(1e-8)
        n_leaves, n_splits, level, splits = 1, 0, 0, []
        while n_leaves < k:
            plan = self._schedule(centers, sizes, sse, divisible, n_leaves, min_size, L, key,
                                  level, cosine)
            if plan is None:
                break
            sel, slot_valid, slot_of, cen_h = plan
            cen = torch.from_numpy(cen_h).to(home)
            slot_of_s = sh.put(torch.from_numpy(slot_of))
            pos, wv = {}, {}
            for i in sh.local:
                p = slot_of_s[i][assign[i]]
                pos[i] = torch.where(w[i] > 0, p, torch.full_like(p, -1))
                wv[i] = torch.where(pos[i] >= 0, w[i], torch.zeros_like(w[i]))
            valid2 = torch.from_numpy(np.repeat(slot_valid, 2).astype(np.float32)).to(home)

            # the constrained 2-means Lloyd loop over every splitting leaf
            it, move = 0, np.float32(np.inf)
            while it < self.max_iter and move > tol_sq:
                cen_s = sh.put(cen)
                sums, counts = (t.to(cen.dtype) for t in sh.sum(
                    lambda i, s: _lloyd_pass(xs[i], wv[i], pos[i], cen_s[i])))
                new_cen = torch.where((counts > 0)[:, None],
                                      sums / torch.clamp(counts, min=1.0)[:, None], cen)
                if cosine:
                    new_cen = normalize_rows(new_cen)
                move = np.float32((((new_cen - cen) ** 2).sum(dim=1) * valid2).max().item())
                cen = new_cen
                it += 1
            cen_s = sh.put(cen)
            passes = {i: _stats_pass(xs[i], wv[i], pos[i], cen_s[i]) for i in sh.local}
            counts, csse = (t.to(cen.dtype) for t in sh.sum(lambda i, s: passes[i][:2]))
            counts2, csse2 = (a.reshape(L, 2) for a in
                              torch.stack([counts, csse]).cpu().numpy())
            cen2 = cen.cpu().numpy().reshape(L, 2, d)
            info["lloyd_iters"] += it
            info["host_syncs"] += it + 1
            info["levels"].append(it)

            succ, new_id, grown = self._record_level(
                centers, sizes, sse, divisible, splits, level, n_leaves, sel, slot_valid,
                counts2, csse2, cen2)
            succ_s, new_id_s = sh.put(torch.from_numpy(succ)), sh.put(torch.from_numpy(new_id))
            for i in sh.local:
                safe_p = torch.clamp(pos[i], 0, L - 1)
                relabel = (pos[i] >= 0) & (passes[i][2] == 1) & succ_s[i][safe_p]
                assign[i] = torch.where(relabel, new_id_s[i][safe_p], assign[i])
            del passes
            n_leaves += grown
            n_splits += grown
            level += 1
        cost = float(sse[:k][sizes[:k] > 0].sum())
        return cost, centers, sizes, sse, n_splits, splits

    def _fit_outofcore(self, hd: HostDataset, mesh) -> BisectingKMeansModel:
        """Rows ≫ device memory: the same level algorithm with each row's
        leaf on the host (n int32) and every Lloyd iteration and stats
        pass a sweep over the blocks streamed over ``mesh`` (each block's
        shards on their devices, their float64 sums added in shard order),
        recentered around the global mean (no shift on the sphere), the
        same seeds and restarts, so the split tree is the resident one up
        to rounding."""
        k, d = self.k, hd.n_features
        if hd.n == 0:
            raise ValueError("BisectingKMeans fit on an empty dataset")
        cosine = self.distance_measure == "cosine"
        L = self._leaves_a_level()
        n_blocks, b = hd.block_shape(mesh)
        per = b // mesh.devices.shape[0]
        dev = stream_home(mesh)

        def prep(sh):
            return _cosine_prep(sh.x, sh.w) if cosine else sh.x

        def sweep(fn):
            """``fn(block index, shard index, shard)`` summed over every
            block's shards, then over the blocks (float64, on ``dev``)."""
            tot = None
            for bi, blk in enumerate(hd.blocks(mesh)):
                s = shard_sum(blk, lambda i, sh: fn(bi, i, sh))
                tot = s if tot is None else add_stats(tot, s)
            return tot

        # pass 0: the global mean → the shift and the root center
        s0, sx = (v.cpu().numpy() for v in sweep(lambda bi, i, sh: _root_moments(prep(sh),
                                                                                 sh.w)))
        sw = max(float(np.float32(s0)), 0.0)
        if sw == 0.0:
            raise ValueError("BisectingKMeans fit on an empty dataset")
        mean = sx.astype(np.float32) / max(sw, 1.0)
        shift = np.zeros((d,), np.float32) if cosine else mean.astype(np.float32)
        root = mean.astype(np.float32) - shift
        if cosine:
            root = root / max(np.linalg.norm(root), 1e-12)
        shift_dev = torch.from_numpy(shift).to(dev)
        # the mean and the root SSE: one fetch each
        info = {"trees": self.n_restarts, "levels": [], "lloyd_iters": 0, "host_syncs": 2}

        # pass 1: the root's SSE
        root_cen = torch.from_numpy(np.broadcast_to(root, (2, d)).astype(np.float32)).to(dev)

        def root_sse_of(bi, i, sh):
            pos0 = torch.zeros((sh.x.shape[0],), dtype=torch.int64, device=sh.x.device)
            return _bkm_stats_block(prep(sh), sh.w, pos0, root_cen.to(sh.x.device),
                                    shift_dev.to(sh.x.device))[1:2]

        root_sse = float(sweep(root_sse_of)[0].cpu().numpy().astype(np.float32).sum())
        min_size = self._min_size(sw)

        def block_pos(bi: int, i: int, assign, slot_of) -> np.ndarray:
            """Shard ``i`` of block ``bi``: its rows' leaf slots (−1 past n)."""
            s = bi * b + i * per
            e = min(s + per, hd.n)
            p = np.full((per,), -1, np.int64)
            if e > s:
                p[: e - s] = slot_of[np.clip(assign[s:e], 0, k)]
            return p

        def grow(key):
            centers = np.zeros((k + 1, d), np.float32)
            centers[0] = root
            sizes = np.zeros((k + 1,), np.float32)
            sizes[0] = sw
            sse = np.zeros((k + 1,), np.float32)
            sse[0] = root_sse
            divisible = np.zeros((k + 1,), bool)
            divisible[0] = True
            assign = np.zeros((hd.n,), np.int32)
            n_leaves, n_splits, level, splits = 1, 0, 0, []
            while n_leaves < k:
                plan = self._schedule(centers, sizes, sse, divisible, n_leaves, min_size, L,
                                      key, level, cosine)
                if plan is None:
                    break
                sel, slot_valid, slot_of, cen = plan
                cen = cen.astype(np.float32)
                valid2 = np.repeat(slot_valid, 2)

                def shard_args(bi, i, sh, cen_dev):
                    dv = sh.x.device
                    return (prep(sh), sh.w,
                            torch.from_numpy(block_pos(bi, i, assign, slot_of)).to(dv),
                            cen_dev.to(dv), shift_dev.to(dv))

                it = 0
                for it in range(1, self.max_iter + 1):
                    cen_dev = torch.from_numpy(cen).to(dev)
                    sums, counts = (v.cpu().numpy().astype(np.float32) for v in sweep(
                        lambda bi, i, sh: _bkm_lloyd_block(*shard_args(bi, i, sh, cen_dev))))
                    new_cen = np.where((counts > 0)[:, None],
                                       sums / np.maximum(counts, 1.0)[:, None], cen)
                    if cosine:
                        new_cen = normalize_rows(torch.from_numpy(
                            np.ascontiguousarray(new_cen, np.float32))).numpy()
                    move = float(np.max(np.sum((new_cen - cen) ** 2, axis=1) * valid2))
                    cen = new_cen.astype(np.float32)
                    if move <= 1e-8:
                        break
                cen_dev = torch.from_numpy(cen).to(dev)
                counts_t = sse_t = None
                bits_blocks = []
                for bi, blk in enumerate(hd.blocks(mesh)):
                    out = {}

                    def stats(i, sh):
                        out[i] = _bkm_stats_block(*shard_args(bi, i, sh, cen_dev))
                        return out[i][:2]

                    c, cs = shard_sum(blk, stats)
                    counts_t = c if counts_t is None else counts_t + c
                    sse_t = cs if sse_t is None else sse_t + cs
                    # a block on the card lives until the iterator advances:
                    # its bits (every shard's, in row order) come to the host now
                    bits_blocks.append((bi, shard_rows(blk, lambda i, sh: out[i][2])))
                counts2 = counts_t.cpu().numpy().astype(np.float32).reshape(L, 2)
                csse2 = sse_t.cpu().numpy().astype(np.float32).reshape(L, 2)
                info["lloyd_iters"] += it
                # a fetch a Lloyd iteration, a bit vector a block, the level's sums
                info["host_syncs"] += it + n_blocks + 1
                info["levels"].append(it)

                succ, new_id, grown = self._record_level(
                    centers, sizes, sse, divisible, splits, level, n_leaves, sel, slot_valid,
                    counts2, csse2, cen.reshape(L, 2, d))
                for bi, bit in bits_blocks:
                    s, e = bi * b, min(bi * b + b, hd.n)
                    p = slot_of[np.clip(assign[s:e], 0, k)]
                    safe_p = np.clip(p, 0, L - 1)
                    relabel = (p >= 0) & (bit[: e - s] == 1) & succ[safe_p]
                    if relabel.any():
                        seg = assign[s:e]
                        seg[relabel] = new_id[safe_p[relabel]]
                        assign[s:e] = seg
                n_leaves += grown
                n_splits += grown
                level += 1
                if grown == 0 and not divisible[:k].any():
                    break
            cost = float(sse[:k][sizes[:k] > 0].sum())
            return cost, centers, sizes, sse, n_splits, splits

        return self._best_tree(grow, shift, info)

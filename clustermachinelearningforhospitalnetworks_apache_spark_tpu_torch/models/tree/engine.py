"""Level-order histogram tree growth (the JAX package's
``models/tree/engine.py``, resident path).

Every level of every tree is grown at once over a padded frontier of
``2**depth`` heap slots: one K3 launch (``ops/tree_hist.py``) builds the
(T, LN, d, B, S) stat histograms, the split of each node is selected on
the device, and rows move to their child slots on the device.  The level
loop makes no host sync: the winners of all levels are packed into one
tensor and fetched once, after the last level.  The host then fills the
flat heap arrays (``_ForestRecorder``, copied unchanged).

Draws match the JAX package bit for bit (``prng.py``): the per-node
feature subset is rank-of-uniform over ``fold_in(key(seed), depth)`` and
the bootstrap is ``poisson(key(seed), rate, (T, n_pad))``.

``grow_forest(..., defer_fetch=True)`` returns a :class:`DeferredForest`
whose winners stay on the device; :func:`device_tree_arrays` turns them
into heap tensors that ``predict_forest`` walks, so the GBT boosting loop
chains round t+1's residuals off round t's tree with no host sync and
fetches every round's winners once, at the end.  ``bin_thresholds=`` and
``binned_t=`` let a caller that grows many trees on one feature matrix
bin it once.

The growth runs over data shards (``models.base.Shards``): a
DeviceDataset is one shard on its device, a ``ShardedDataset`` (or the
shards of a boosting loop) spreads its rows over a mesh, and the rows stay
on their shards.  The thresholds come from the global sample, each shard
bins its own rows, the Poisson bootstrap is drawn once over the global
padded rows (the reference's (T, n_pad) draw) and cut by columns, and
every level runs K3 once a data shard on that shard's device, sums the
(T, LN, d, B, S) histograms in ascending shard order
(``collectives.ordered_sum``), selects the splits once on the home device
and moves the winners back to each shard, which advances its own rows.  The reference replicates the trees over the model
axis (its histogram's in_specs shard only the rows), so each data shard
runs once, on its ``(i, 0)`` entry.  In one process the level loop makes
no host sync; across processes each level's gather is one round trip.

``grow_forest_outofcore`` grows from a :class:`~...parallel.outofcore.HostDataset`,
on one device or over a mesh's data shards: each level streams the
blocks, re-bins each block shard, replays the recorded splits to find its
rows' nodes and runs one K3 launch a data shard of a block; the shards'
histograms add in ascending shard order, then the blocks, and the same
selection picks the winners once on the home device.  Its bootstrap is
drawn per block on the home device, ``poisson(fold_in(key(seed), block),
rate, (T, b))`` over the block's (mesh-rounded) rows, and cut by columns
into the shards, so every level's re-stream of a block draws the same
weights, and the JAX package's draw on the same mesh shape.  A level is
its checkpoint boundary (``io/fit_checkpoint.py``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ... import prng
from ...ops.tree_hist import fused_level_hist
from .binning import digitize, quantile_thresholds


# ------------------------------------------------------------- selection
def select_splits(hist, feat_mask, min_inst: float, min_gain: float, task: str,
                  is_cat=None):
    """On-device split selection from a level's (T, LN, d, B, S) histogram
    (the JAX ``_make_select_fn``).

    ``feat_mask`` (T, LN, d) zero-masks features outside the node's
    subset; ``is_cat`` (d,) bool tensor marks categorical features, whose
    bins are sorted per node by label mean (regression) or mean class
    index (classification), empty bins last, with a stable sort, before
    the prefix scan; the winning prefix becomes a uint32 category mask
    (held in int64).  Regression stats are (w, Σy, Σy²), classification
    stats per-class weights.  Ties take the first (feature, bin), as
    ``argmax`` does.  → (agg (T,LN,S), best_gain, best_feat, best_bin,
    do_split, catmask), all (T, LN) but agg."""
    T, LN, d, B, S = hist.shape
    dev = hist.device
    agg = hist[:, :, 0, :, :].sum(dim=2)                      # (T, LN, S)
    order = None
    if is_cat is not None:
        if task == "regression":
            w_bin, s_bin = hist[..., 0], hist[..., 1]
        else:
            cls = torch.arange(S, dtype=torch.float32, device=dev)
            w_bin = hist.sum(-1)
            s_bin = (hist * cls).sum(-1)
        key = torch.where(w_bin > 0, s_bin / torch.clamp(w_bin, min=1e-12),
                          torch.full_like(w_bin, float("inf")))
        natural = torch.arange(B, dtype=torch.float32, device=dev).expand_as(key)
        key = torch.where(is_cat[None, None, :, None], key, natural)
        order = torch.sort(key, dim=3, stable=True).indices   # (T, LN, d, B)
        hist = torch.take_along_dim(hist, order[..., None], dim=3)

    cum = torch.cumsum(hist, dim=3)
    total = cum[:, :, :, -1:, :]
    if task == "regression":
        wl, sl, ql = cum[..., 0], cum[..., 1], cum[..., 2]
        wt, st, qt = total[..., 0], total[..., 1], total[..., 2]
        wr, sr, qr = wt - wl, st - sl, qt - ql

        def sse(w, s, q):
            return torch.where(w > 0, q - s * s / torch.clamp(w, min=1e-12),
                               torch.zeros_like(q))

        gain = sse(wt, st, qt) - sse(wl, sl, ql) - sse(wr, sr, qr)
        node_w = agg[..., 0]
    else:
        left, right = cum, total - cum
        wl, wr = left.sum(-1), right.sum(-1)
        wt = total.sum(-1)

        def gini(counts, w):
            return torch.where(w > 0, w - (counts * counts).sum(-1) / torch.clamp(w, min=1e-12),
                               torch.zeros_like(w))

        gain = gini(total, wt) - gini(left, wl) - gini(right, wr)
        node_w = agg.sum(-1)

    valid = (wl >= min_inst) & (wr >= min_inst) & (feat_mask[..., None] > 0)
    gain = torch.where(valid, gain, torch.full_like(gain, float("-inf")))
    gain[..., -1].fill_(float("-inf"))         # last bin: empty right child

    flat = gain.reshape(T, LN, d * B)
    best = torch.argmax(flat, dim=2)
    best_gain = torch.take_along_dim(flat, best[..., None], dim=2)[..., 0]
    do_split = torch.isfinite(best_gain) & (best_gain > min_gain) & (node_w >= 2.0 * min_inst)
    best_feat = torch.div(best, B, rounding_mode="floor").to(torch.int32)
    best_bin = (best % B).to(torch.int32)
    if order is not None:
        ord_win = torch.take_along_dim(
            order, best_feat.to(torch.int64)[..., None, None], dim=2
        )[:, :, 0, :]                                           # (T, LN, B)
        take = torch.arange(B, device=dev)[None, None, :] <= best_bin[..., None]
        bits = torch.where(take, torch.bitwise_left_shift(torch.ones_like(ord_win),
                                                          torch.clamp(ord_win, max=31)),
                           torch.zeros_like(ord_win))
        catmask = bits.sum(-1)
    else:
        catmask = torch.zeros(best_bin.shape, dtype=torch.int64, device=dev)
    return agg, best_gain, best_feat, best_bin, do_split, catmask


def advance_level(binned_t, node_id, pos, feat, bin_, do_split, level_base: int,
                  catmask=None, cat_flags=None):
    """Move the rows on the current frontier to their child heap slots
    (the JAX ``_advance_level``, with gathers where it unrolled selects).

    A row goes right iff its bin in the node's split feature is above the
    split bin — or, for a categorical split, iff its category's bit is
    not in the node's mask (``cat_flags`` (d,) bool marks categorical
    features; None on all-continuous fits).  Rows of unsplit nodes park
    at −1."""
    feat_eff = torch.where(do_split, feat, torch.full_like(feat, -1)).to(torch.int64)
    active = pos >= 0
    safe = torch.clamp(pos, min=0).to(torch.int64)
    f = torch.where(active, torch.gather(feat_eff, 1, safe), torch.full_like(safe, -1))
    b = torch.gather(bin_.to(torch.int64), 1, safe)
    fb = torch.gather(binned_t, 0, torch.clamp(f, min=0)).to(torch.int64)
    right = (fb > b).to(torch.int32)
    if cat_flags is not None:
        cm = torch.gather(catmask, 1, safe)
        icat = cat_flags[torch.clamp(f, min=0)]
        in_left = ((cm >> torch.clamp(fb, max=31)) & 1) > 0
        right = torch.where(icat, (~in_left).to(torch.int32), right)
    child = 2 * (level_base + pos) + 1 + right
    moved = torch.where(active, torch.full_like(node_id, -1), node_id)
    return torch.where(active & (f >= 0), child, moved)


def subset_mask(seed: int, depth: int, T: int, level_nodes: int, d: int, k: int,
                device) -> torch.Tensor:
    """Exactly ``k`` of ``d`` features per (tree, node): feature f is in
    iff the rank of ``u[t, p, f]`` among the node's uniforms is below k,
    with ``u = uniform(fold_in(key(seed), depth), (T, LN, d))``."""
    u = prng.uniform(prng.fold_in(prng.key(seed), depth), (T, level_nodes, d), device)
    ranks = torch.argsort(torch.argsort(u, dim=-1, stable=True), dim=-1, stable=True)
    return (ranks < k).to(torch.float32)


def bootstrap_weights(seed: int, rate: float, T: int, n_pad: int, device) -> torch.Tensor:
    """Poisson(rate) bootstrap counts per (tree, row) as float32."""
    return prng.poisson(prng.key(seed), rate, (T, n_pad), device).to(torch.float32)


def block_bootstrap(seed: int, block_idx: int, rate: float, T: int, b: int,
                    device) -> torch.Tensor:
    """One streamed block's Poisson(rate) bootstrap counts (T, b) as
    float32, keyed by (seed, block index): every level's re-stream of the
    block draws the same weights.  A stream of another shape than the
    resident (T, n_pad) draw, so out-of-core and resident forests agree
    only with ``bootstrap=False``."""
    k = prng.fold_in(prng.key(seed), block_idx)
    return prng.poisson(k, rate, (T, b), device).to(torch.float32)


def bin_feature_matrix(x: torch.Tensor, thr: np.ndarray, cat: dict[int, int] | None = None,
                       w: torch.Tensor | None = None) -> torch.Tensor:
    """(n, d) features → (d, n) int32 bin matrix (row axis last).

    Continuous columns digitize against ``thr``; a categorical column's
    bins are its category ids (rounded half to even).  A valid (w > 0)
    row whose category falls outside [0, arity) raises, as Spark does."""
    binned = digitize(x, thr)
    if cat:
        feats = sorted(cat)
        idx = torch.as_tensor(feats, dtype=torch.int64, device=x.device)
        hi = torch.as_tensor([cat[f] - 1 for f in feats], dtype=torch.int32, device=x.device)
        xi = torch.round(x[:, idx].to(torch.float32)).to(torch.int32)
        bad = (xi < 0) | (xi > hi[None, :])
        if w is not None:
            bad = bad & (w[:, None] > 0)
        bad_feat = bad.any(dim=0).cpu().numpy()
        if bad_feat.any():
            f = feats[int(np.flatnonzero(bad_feat)[0])]
            raise ValueError(
                f"categorical feature {f} has values outside [0, "
                f"{cat[f]}) — wrong arity in categorical_features, or the "
                "column is not StringIndexer output"
            )
        binned[:, idx] = xi
    return binned.T.contiguous()


class _ForestRecorder:
    """Host-side accumulation of per-level winners into the flat heap
    arrays + the materialization tail (thresholds, leaf values, parent
    propagation, importance normalization) — copied unchanged from the JAX
    package so both emit identical :class:`GrownForest` artifacts from
    identical winner tensors."""

    def __init__(self, T: int, d: int, S: int, max_depth: int, is_cat: np.ndarray):
        total = 2 ** (max_depth + 1) - 1
        self.max_depth = max_depth
        self.is_cat = is_cat
        self.split_feat = np.full((T, total), -1, dtype=np.int32)
        self.split_bin = np.zeros((T, total), dtype=np.int32)
        self.split_catmask = np.zeros((T, total), dtype=np.uint32)
        self.node_stats = np.zeros((T, total, S), dtype=np.float64)
        self.importances = np.zeros((T, d), dtype=np.float64)

    def record_level(self, depth: int, fetched) -> None:
        agg, best_gain, best_feat, best_bin, do_split, catmask = (
            np.asarray(fetched[0], np.float64),
            np.asarray(fetched[1], np.float64),
            np.asarray(fetched[2], np.int32),
            np.asarray(fetched[3], np.int32),
            np.asarray(fetched[4], bool),
            np.asarray(fetched[5], np.uint32),
        )
        level_nodes = 1 << depth
        level_base = level_nodes - 1
        self.node_stats[:, level_base : level_base + level_nodes] = agg
        if depth == self.max_depth:
            return
        sl = slice(level_base, level_base + level_nodes)
        self.split_feat[:, sl] = np.where(do_split, best_feat, -1)
        self.split_bin[:, sl] = np.where(do_split, best_bin, 0)
        self.split_catmask[:, sl] = np.where(
            do_split & self.is_cat[best_feat], catmask, np.uint32(0)
        )
        for t in range(best_feat.shape[0]):
            np.add.at(
                self.importances[t],
                best_feat[t][do_split[t]],
                best_gain[t][do_split[t]],
            )

    def materialize(
        self, thr: np.ndarray, task: str, num_classes: int,
        cat_arities: tuple[int, ...] | None, B: int,
    ) -> "GrownForest":
        T, total = self.split_feat.shape
        threshold = np.zeros((T, total), dtype=np.float32)
        valid_split = (self.split_feat >= 0) & ~self.is_cat[
            np.maximum(self.split_feat, 0)
        ]
        f_idx = np.maximum(self.split_feat, 0)
        b_idx = np.minimum(self.split_bin, B - 2)
        threshold[valid_split] = thr[f_idx, b_idx][valid_split].astype(np.float32)

        node_stats = self.node_stats
        if task == "regression":
            w = node_stats[..., 0]
            with np.errstate(divide="ignore", invalid="ignore"):
                mean = np.where(
                    w > 0, node_stats[..., 1] / np.maximum(w, 1e-12), 0.0
                )
            value = mean[..., None].astype(np.float32)  # (T, total, 1)
        else:
            w = node_stats.sum(-1, keepdims=True)
            value = np.where(
                w > 0, node_stats / np.maximum(w, 1e-12), 1.0 / num_classes
            ).astype(np.float32)  # (T, total, C) class probabilities

        # propagate values down so un-populated heap slots predict their parent
        for parent in range(total // 2):
            for child in (2 * parent + 1, 2 * parent + 2):
                empty = (
                    node_stats[:, child].sum(-1) <= 0
                    if task == "classification"
                    else node_stats[:, child, 0] <= 0
                )
                value[:, child][empty] = value[:, parent][empty]

        imp = self.importances
        tot_imp = imp.sum(axis=1, keepdims=True)
        imp = np.where(tot_imp > 0, imp / np.maximum(tot_imp, 1e-12), 0.0)
        has_cat = cat_arities is not None and any(a > 0 for a in cat_arities)
        return GrownForest(
            split_feat=self.split_feat,
            split_bin=self.split_bin,
            threshold=threshold,
            value=value,
            importances=imp,
            max_depth=self.max_depth,
            bin_thresholds=thr,
            split_catmask=self.split_catmask if has_cat else None,
            cat_arities=(
                np.asarray(cat_arities, dtype=np.int32) if has_cat else None
            ),
        )


@dataclass
class GrownForest:
    """Flat heap-layout ensemble (T trees × (2^(depth+1)-1) nodes)."""

    split_feat: np.ndarray      # (T, total) int32, -1 = leaf
    split_bin: np.ndarray       # (T, total) int32
    threshold: np.ndarray       # (T, total) float32 — real-valued split point
    value: np.ndarray           # (T, total, V) float32 — leaf prediction stats
    importances: np.ndarray     # (T, d)
    max_depth: int
    bin_thresholds: np.ndarray  # (d, B-1)
    split_catmask: np.ndarray | None = None  # (T, total) uint32 — left-set
    cat_arities: np.ndarray | None = None    # (d,) int32, 0 = continuous


def _frontier(node_id, level_nodes: int) -> torch.Tensor:
    """Each row's slot on the level's frontier, −1 for rows elsewhere."""
    pos = node_id - (level_nodes - 1)
    return torch.where((node_id >= 0) & (pos >= 0) & (pos < level_nodes), pos,
                       torch.full_like(pos, -1))


def _level_loop(sh, binned, base, w_tree, T: int, d: int, B: int, task: str, max_depth: int,
                seed: int, subset_k: int | None, min_inst: float, min_gain: float, is_cat,
                cat_sh):
    """Grow every level over the data shards of ``sh`` (``models.base.
    Shards``) without a host sync in one process: ``binned`` / ``base`` /
    ``w_tree`` map each local shard to its tensors on its device; K3 once a
    shard a level, the histograms summed in ascending shard order on the
    home device, one selection there, the winners moved to every shard.
    → per level the home device's winners (agg, gain, feat, bin, do_split,
    catmask)."""
    from ...parallel.collectives import ordered_sum

    home = sh.home
    node = {i: torch.zeros((T, binned[i].shape[1]), dtype=torch.int32, device=binned[i].device)
            for i in sh.local}
    level_out = []
    for depth in range(max_depth + 1):
        level_nodes = 1 << depth
        level_base = level_nodes - 1
        pos = {i: _frontier(node[i], level_nodes) for i in sh.local}
        if subset_k is not None:
            mask = subset_mask(seed, depth, T, level_nodes, d, subset_k, home)
        else:
            mask = torch.ones((T, level_nodes, d), dtype=torch.float32, device=home)
        parts: list = [None] * sh.D
        for i in sh.local:
            parts[i] = fused_level_hist(binned[i], base[i], w_tree[i], pos[i], level_nodes, B)
        hist = ordered_sum(parts, sh.mesh)
        out = select_splits(hist, mask, min_inst, min_gain, task, is_cat)
        level_out.append(out)
        if depth < max_depth:
            _, _, feat, bin_, split, catmask = out
            for i in sh.local:
                dev = binned[i].device
                node[i] = advance_level(binned[i], node[i], pos[i], feat.to(dev), bin_.to(dev),
                                        split.to(dev), level_base, catmask.to(dev), cat_sh[i])
    return level_out


def _pack_levels(level_out) -> torch.Tensor:
    """Every level's winners in one float64 (T, Σ LN·(S+5)) tensor, packed
    column-wise (exact: the ids, bins and masks fit float64), so one copy
    fetches them."""
    T = level_out[0][0].shape[0]
    return torch.cat([torch.cat([agg.reshape(T, -1).to(torch.float64)]
                                + [v.to(torch.float64) for v in rest], dim=1)
                      for agg, *rest in level_out], dim=1)


def _unpack_levels(row: np.ndarray, T: int, S: int, max_depth: int) -> list:
    """:func:`_pack_levels`'s (T, W) block on the host → per level the
    six winner arrays."""
    out, col = [], 0
    for depth in range(max_depth + 1):
        LN = 1 << depth
        width = LN * (S + 5)
        out.append(_unpack_level(row[:, col : col + width], T, LN, S))
        col += width
    return out


def _unpack_level(level: np.ndarray, T: int, LN: int, S: int):
    agg = level[:, : LN * S].reshape(T, LN, S)
    rest = level[:, LN * S :].reshape(T, 5, LN)
    return (agg, rest[:, 0], rest[:, 1].astype(np.int32), rest[:, 2].astype(np.int32),
            rest[:, 3] > 0, rest[:, 4].astype(np.uint32))


@dataclass
class DeferredForest:
    """:func:`grow_forest` output with the host fetch deferred: the
    per-level winners are still device tensors (possibly still being
    computed).  The GBT loop walks the tree on the device through
    :func:`device_tree_arrays`, so round t+1's residuals chain off round t
    with no host sync, and fetches every round's winners at once at the
    end of the fit."""

    level_out: list             # per level: the six winner tensors
    thr: np.ndarray             # (d, B-1) float64 bin thresholds
    task: str
    num_classes: int
    cat_arities: tuple[int, ...] | None
    B: int
    max_depth: int
    is_cat_host: np.ndarray
    T: int
    d: int
    S: int

    def packed(self) -> torch.Tensor:
        """The winners in one (T, W) float64 device tensor
        (:func:`fetch_packed` reads it back)."""
        return _pack_levels(self.level_out)

    def fetch(self) -> GrownForest:
        return self.fetch_packed(self.packed().cpu().numpy())

    def fetch_packed(self, row: np.ndarray) -> GrownForest:
        """Materialize from an already fetched :meth:`packed` block (batch
        several rounds' blocks into one copy, then call this per round)."""
        return self.fetch_from(_unpack_levels(row, self.T, self.S, self.max_depth))

    def fetch_from(self, fetched_levels) -> GrownForest:
        """Materialize from fetched per-level winner arrays."""
        rec = _ForestRecorder(self.T, self.d, self.S, self.max_depth, self.is_cat_host)
        for depth, fetched in enumerate(fetched_levels):
            rec.record_level(depth, fetched)
        return rec.materialize(self.thr, self.task, self.num_classes, self.cat_arities,
                               self.B)


def device_tree_arrays(level_out, thr_dev, is_cat_dev, B: int):
    """→ (split_feat, threshold, value (T, total, 1), catmask) heap tensors
    on the device from a :class:`DeferredForest`'s level winners: the
    device mirror of ``_ForestRecorder.record_level`` + ``materialize`` for
    regression trees (S = 3 stats (w, Σy, Σy²), the GBT path), so
    ``predict_forest`` walks a just-grown tree without a host sync.  The
    leaf division runs in float32 (the recorder's in float64); on
    integer-exact sums both round alike.  ``thr_dev`` (d, B-1) float32,
    ``is_cat_dev`` (d,) bool."""
    max_depth = len(level_out) - 1
    feats, bins, valids, masks, stats = [], [], [], [], []
    for depth, (agg, _gain, feat, bin_, split, catmask) in enumerate(level_out):
        stats.append(agg)
        if depth == max_depth:                      # the deepest level: leaves
            feats.append(torch.full_like(feat, -1))
            bins.append(torch.zeros_like(bin_))
            valids.append(torch.zeros_like(split))
            masks.append(torch.zeros_like(catmask))
        else:
            feats.append(torch.where(split, feat, torch.full_like(feat, -1)))
            bins.append(torch.where(split, bin_, torch.zeros_like(bin_)))
            valids.append(split)
            masks.append(torch.where(split & is_cat_dev[feat.to(torch.int64)], catmask,
                                     torch.zeros_like(catmask)))
    split_feat = torch.cat(feats, dim=1)            # (T, total)
    split_bin = torch.cat(bins, dim=1)
    do_split = torch.cat(valids, dim=1)
    catmask = torch.cat(masks, dim=1)
    node_stats = torch.cat(stats, dim=1)            # (T, total, 3)

    w = node_stats[..., 0]
    value = torch.where(w > 0, node_stats[..., 1] / torch.clamp(w, min=1e-12),
                        torch.zeros_like(w))
    # un-populated slots predict their parent: level by level, top down,
    # which is the recorder's slot-order loop (a parent precedes its
    # children)
    for depth in range(1, max_depth + 1):
        lo, hi = (1 << depth) - 1, (1 << (depth + 1)) - 1
        parent = value[:, (lo - 1) // 2 : (hi - 1) // 2].repeat_interleave(2, dim=1)
        value[:, lo:hi] = torch.where(w[:, lo:hi] <= 0, parent, value[:, lo:hi])

    f_idx = torch.clamp(split_feat, min=0).to(torch.int64)
    valid_split = do_split & ~is_cat_dev[f_idx]
    thr_at = thr_dev[f_idx, torch.clamp(split_bin, max=B - 2).to(torch.int64)]
    threshold = torch.where(valid_split, thr_at, torch.zeros_like(thr_at))
    return split_feat, threshold, value[..., None].to(torch.float32), catmask


def _stats_base(y: torch.Tensor, task: str, S: int) -> torch.Tensor:
    """Per-row base stats (S, n): (1, y, y²) for regression, the class
    one-hots for classification."""
    if task == "regression":
        y = y.to(torch.float32)
        return torch.stack([torch.ones_like(y), y, y * y], dim=0).contiguous()
    yi = y.to(torch.int32)
    return (yi[None, :] == torch.arange(S, dtype=torch.int32, device=y.device)[:, None]).to(
        torch.float32).contiguous()


def grow_forest(
    ds,
    *,
    task: str,                      # "regression" | "classification"
    num_classes: int = 2,
    num_trees: int = 1,
    max_depth: int = 5,
    max_bins: int = 32,
    min_instances_per_node: int = 1,
    min_info_gain: float = 0.0,
    feature_subset_size: int | None = None,   # per-node; None = all features
    bootstrap: bool = False,
    subsampling_rate: float = 1.0,
    seed: int = 0,
    init_sample_size: int = 65536,
    categorical_features: dict[int, int] | None = None,
    bin_thresholds: np.ndarray | None = None,
    binned_t: torch.Tensor | None = None,
    defer_fetch: bool = False,
    fused_levels: bool = True,
    cat_flags: torch.Tensor | None = None,
    timings: dict | None = None,
) -> "GrownForest | DeferredForest":
    """Train ``num_trees`` trees level by level over the data shards of
    ``ds``: a DeviceDataset (one shard, on its device), a
    ``ShardedDataset`` or a ``models.base.Shards`` (see the module
    docstring).

    Steps: quantile thresholds from a host sample of valid rows; the
    (d, n) bin matrix on the device; per-tree weights (validity × Poisson
    bootstrap when ``bootstrap``); per-row stats (w, y, y²) or class
    one-hots; then ``max_depth + 1`` levels of K3 + selection + advance
    with no host sync, and one fetch of every level's winners.

    ``bin_thresholds`` ((d, max_bins-1), from
    ``binning.quantile_thresholds``) skips the sample and its quantiles;
    ``binned_t`` (each local shard's (d, n_pad) int32 bin matrix as
    ``{shard: tensor}``, or the tensor of a one-device fit, with the
    matching ``bin_thresholds``) skips the digitize too.
    ``defer_fetch=True`` returns a
    :class:`DeferredForest` and makes no host sync at all (not even the
    empty-dataset check of the ``bin_thresholds`` route: the caller has
    checked).  ``fused_levels`` is the reference's switch and changes
    nothing here: the level loop already makes no host sync.
    ``cat_flags``, the (d,) bool device tensor of ``categorical_features``,
    skips its host-to-device copy (a boosting loop makes it once).

    ``categorical_features`` maps feature index → arity (≤ min(32,
    max_bins)); those columns hold category ids and split as unordered
    sets.  ``timings``, when given, receives host seconds per step
    (each step ends with a device sync, so only pass it when timing)."""
    from ...parallel.sharding import sample_valid_rows
    from ..base import Shards

    sh = ds if isinstance(ds, Shards) else Shards(ds)
    d, T, B, home = sh.n_features, num_trees, max_bins, sh.home

    def tick(name, t0):
        if timings is not None:
            for dev in {sh.device(i) for i in sh.local}:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0
        return time.perf_counter()

    cat = dict(categorical_features or {})
    cat_arities = _check_categorical(cat, d, B)

    t0 = time.perf_counter()
    if bin_thresholds is not None:
        thr = np.asarray(bin_thresholds, dtype=np.float64)
        if thr.shape != (d, B - 1):
            raise ValueError(f"bin_thresholds shape {thr.shape} != ({d}, {B - 1})")
        if not defer_fetch and sh.count() == 0.0:
            raise ValueError("tree fit on an empty dataset")
    else:
        sample = sample_valid_rows(sh.dataset(), init_sample_size, seed)
        if sample.shape[0] == 0:
            raise ValueError("tree fit on an empty dataset")
        thr = quantile_thresholds(sample, B)
    t0 = tick("thresholds", t0)
    if binned_t is None:
        binned = {i: bin_feature_matrix(s.x, thr, cat, w=s.w) for i, s in sh.data.items()}
    elif bin_thresholds is None:
        raise ValueError("binned_t requires the matching bin_thresholds")
    else:
        binned = binned_t if isinstance(binned_t, dict) else {0: binned_t}
        for i, s in sh.data.items():
            got = tuple(binned[i].shape) if i in binned else None
            if got != (d, s.n_padded):
                raise ValueError(f"binned_t of shard {i}: shape {got} != ({d}, {s.n_padded})")
    t0 = tick("digitize", t0)

    if bootstrap:
        # the reference's draw over the global padded rows, cut by columns
        boot = bootstrap_weights(seed, float(subsampling_rate), T, sh.n_padded, home)
        per = sh.n_padded // sh.D
        w_tree = {i: boot[:, i * per:(i + 1) * per].to(s.x.device)
                  * s.w.to(torch.float32)[None, :] for i, s in sh.data.items()}
    else:
        w_tree = {i: s.w.to(torch.float32)[None, :].expand(T, s.n_padded).contiguous()
                  for i, s in sh.data.items()}
    S = 3 if task == "regression" else num_classes
    base_t = {i: _stats_base(s.y, task, S) for i, s in sh.data.items()}
    is_cat_host = np.asarray([f in cat for f in range(d)], dtype=bool)
    if not cat:
        is_cat = None
    elif cat_flags is not None:
        is_cat = cat_flags.to(home)
    else:
        is_cat = torch.as_tensor(is_cat_host, device=home)
    cat_sh = {i: None if is_cat is None else is_cat.to(s.x.device) for i, s in sh.data.items()}
    subset_k = (
        feature_subset_size
        if feature_subset_size is not None and feature_subset_size < d
        else None
    )
    t0 = tick("draws", t0)

    level_out = _level_loop(sh, binned, base_t, w_tree, T, d, B, task, max_depth, seed,
                            subset_k, float(min_instances_per_node), float(min_info_gain),
                            is_cat, cat_sh)
    t0 = tick("level_loop", t0)
    deferred = DeferredForest(level_out=level_out, thr=thr, task=task,
                              num_classes=num_classes, cat_arities=cat_arities, B=B,
                              max_depth=max_depth, is_cat_host=is_cat_host, T=T, d=d, S=S)
    if defer_fetch:
        return deferred
    grown = deferred.fetch()          # the one host fetch
    tick("fetch_materialize", t0)
    return grown


def _check_categorical(cat: dict[int, int], d: int, B: int) -> tuple | None:
    """Validate ``categorical_features`` → the per-feature arities, or
    None on an all-continuous fit."""
    for f, arity in cat.items():
        if not 0 <= f < d:
            raise ValueError(f"categorical feature index {f} out of range [0, {d})")
        if not 2 <= arity <= min(32, B):
            raise ValueError(
                f"categorical feature {f} arity {arity} must be in "
                f"[2, min(32, max_bins={B})]"
            )
    return tuple(cat.get(f, 0) for f in range(d)) if cat else None


def grow_forest_outofcore(
    hd,
    *,
    task: str,
    num_classes: int = 2,
    num_trees: int = 1,
    max_depth: int = 5,
    max_bins: int = 32,
    min_instances_per_node: int = 1,
    min_info_gain: float = 0.0,
    feature_subset_size: int | None = None,
    bootstrap: bool = False,
    subsampling_rate: float = 1.0,
    seed: int = 0,
    device=None,
    init_sample_size: int = 65536,
    categorical_features: dict[int, int] | None = None,
    bin_thresholds: np.ndarray | None = None,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 1,
    on_level=None,
    mesh=None,
) -> GrownForest:
    """Grow from a HostDataset on ``device`` (default the card) or over
    ``mesh``: every level is one more sufficient-stats pass over the
    streamed blocks, so device memory stays bounded by
    ``hd.max_device_rows``.

    Per level, each block is re-binned against the fit-start thresholds
    (from ``hd.sample_rows`` or the caller's ``bin_thresholds``), replayed
    through the splits recorded so far (``advance_level``, the routing the
    resident loop applies once per level) and given its (T, LN, d, B, S)
    histogram by one K3 launch a data shard; the shards' histograms are
    summed in ascending shard order, then the blocks, and
    ``select_splits`` picks the winners on the home device.  With
    float32-exact sums the splits are the resident engine's.

    ``checkpoint_dir`` commits the thresholds and the recorder's arrays
    every ``checkpoint_every`` levels; a resumed fit rebuilds the recorded
    levels' winners from them and goes on at the next level.
    ``on_level(depth)`` fires after each level's commit."""
    from ...parallel.collectives import ordered_sum
    from ...parallel.outofcore import block_shards, stream_home, stream_mesh

    sm = stream_mesh(mesh, device)
    dev = stream_home(sm)
    d = hd.n_features
    T = num_trees
    B = max_bins
    cat = dict(categorical_features or {})
    cat_arities = _check_categorical(cat, d, B)
    is_cat_host = np.asarray([f in cat for f in range(d)], dtype=bool)
    is_cat = torch.as_tensor(is_cat_host, device=dev) if cat else None

    if bin_thresholds is not None:
        thr = np.asarray(bin_thresholds, dtype=np.float64)
        if thr.shape != (d, B - 1):
            raise ValueError(f"bin_thresholds shape {thr.shape} != ({d}, {B - 1})")
        if hd.count() == 0.0:
            raise ValueError("tree fit on an empty dataset")
    else:
        sample = hd.sample_rows(init_sample_size, seed)
        if sample.shape[0] == 0:
            raise ValueError("tree fit on an empty dataset")
        thr = quantile_thresholds(sample, B)

    S = 3 if task == "regression" else num_classes
    _, b = hd.block_shape(sm)
    per = b // sm.devices.shape[0]
    subset_k = (
        feature_subset_size
        if feature_subset_size is not None and feature_subset_size < d
        else None
    )
    rec = _ForestRecorder(T, d, S, max_depth, is_cat_host)
    winners: list[tuple] = []   # (feat, bin, do_split, catmask) per level, on the device

    def winners_from_recorder(dep: int) -> tuple:
        """One level's descend inputs from the recorded splits:
        ``split_feat`` holds −1 where no split, ``advance_level``'s own
        convention."""
        sl = slice((1 << dep) - 1, (1 << dep) - 1 + (1 << dep))
        feat = torch.as_tensor(rec.split_feat[:, sl], device=dev)
        return (feat, torch.as_tensor(rec.split_bin[:, sl], device=dev), feat >= 0,
                torch.as_tensor(rec.split_catmask[:, sl].astype(np.int64), device=dev))

    ckpt = None
    start_depth = 0
    if checkpoint_dir:
        from ...io.fit_checkpoint import FitCheckpointer, data_fingerprint

        signature = {
            "estimator": "forest", "storage": "outofcore",
            "task": task, "num_classes": num_classes, "num_trees": T,
            "max_depth": max_depth, "max_bins": B,
            "min_instances_per_node": min_instances_per_node,
            "min_info_gain": min_info_gain,
            "feature_subset_size": feature_subset_size,
            "bootstrap": bootstrap, "subsampling_rate": subsampling_rate,
            # lists, not tuples: the committed signature is compared after
            # a JSON round trip
            "seed": seed, "cat": [list(t) for t in sorted(cat.items())],
            "data": data_fingerprint(hd.x, hd.w),
            "labels": data_fingerprint(np.asarray(hd.y)[:, None]),
            "n": hd.n,
        }
        ckpt = FitCheckpointer(checkpoint_dir, signature)
        resumed = ckpt.resume()
        if resumed is not None:
            step0, arrays, _ = resumed
            thr = arrays["thr"]
            rec.split_feat = arrays["split_feat"]
            rec.split_bin = arrays["split_bin"]
            rec.split_catmask = arrays["split_catmask"]
            rec.node_stats = arrays["node_stats"]
            rec.importances = arrays["importances"]
            winners.extend(winners_from_recorder(dep) for dep in range(step0 + 1))
            start_depth = step0 + 1

    def shard_arrays(sh, i: int, boot):
        """(binned_t, base_t, w_tree) of data shard ``i`` of a streamed
        block (``boot`` the block's (T, b) bootstrap draw, or None)."""
        binned_t = bin_feature_matrix(sh.x, thr, cat, w=sh.w)
        base_t = _stats_base(sh.y, task, S)
        if boot is not None:
            w_tree = boot[:, i * per:(i + 1) * per].to(sh.x.device) * sh.w[None, :]
        else:
            w_tree = sh.w[None, :].expand(T, per).contiguous()
        return binned_t, base_t, w_tree

    def descend(binned_t, upto_depth: int):
        """A shard's rows → their heap node at ``upto_depth``, replaying the
        recorded levels' splits on the shard's device."""
        dv = binned_t.device
        node_id = torch.zeros((T, per), dtype=torch.int32, device=dv)
        cat_d = None if is_cat is None else is_cat.to(dv)
        for dep in range(upto_depth):
            feat, bin_, split, catmask = (t.to(dv) for t in winners[dep])
            node_id = advance_level(binned_t, node_id, _frontier(node_id, 1 << dep), feat,
                                    bin_, split, (1 << dep) - 1, catmask, cat_d)
        return node_id

    min_inst, min_gain = float(min_instances_per_node), float(min_info_gain)
    for depth in range(start_depth, max_depth + 1):
        level_nodes = 1 << depth
        if subset_k is not None:
            mask = subset_mask(seed, depth, T, level_nodes, d, subset_k, dev)
        else:
            mask = torch.ones((T, level_nodes, d), dtype=torch.float32, device=dev)
        hist = None
        for bi, blk in enumerate(hd.blocks(sm)):
            boot = (block_bootstrap(seed, bi, float(subsampling_rate), T, b, dev)
                    if bootstrap else None)
            parts: list = [None] * sm.devices.shape[0]
            for i, sh in block_shards(blk).items():
                binned_t, base_t, w_tree = shard_arrays(sh, i, boot)
                pos = _frontier(descend(binned_t, depth), level_nodes)
                parts[i] = fused_level_hist(binned_t, base_t, w_tree, pos, level_nodes, B)
            h = ordered_sum(parts, sm)
            hist = h if hist is None else hist + h
        agg, gain, feat, bin_, split, catmask = select_splits(
            hist, mask, min_inst, min_gain, task, is_cat)
        winners.append((feat, bin_, split, catmask))
        rec.record_level(depth, tuple(v.cpu().numpy()
                                      for v in (agg, gain, feat, bin_, split, catmask)))
        if ckpt is not None and (depth + 1) % max(checkpoint_every, 1) == 0:
            ckpt.save(depth, {
                "thr": thr,
                "split_feat": rec.split_feat,
                "split_bin": rec.split_bin,
                "split_catmask": rec.split_catmask,
                "node_stats": rec.node_stats,
                "importances": rec.importances,
            })
        if on_level is not None:
            on_level(depth)   # after the commit: the preemption point tests use
    return rec.materialize(thr, task, num_classes, cat_arities, B)


# ---------------------------------------------------------------- predict
def predict_forest(x: torch.Tensor, split_feat, threshold, value, cat_mask=None,
                   cat_flags=None) -> torch.Tensor:
    """Ensemble traversal on ``x``'s device: every tree walks ``max_depth``
    levels of gathers.  x (n, d); split_feat / threshold (T, total); value
    (T, total, V) → (T, n, V) per-tree outputs (the caller aggregates).

    ``cat_mask`` (T, total) + ``cat_flags`` (d,) route categorical split
    nodes: left iff the row's rounded category has its bit in the mask
    (unseen or out-of-range ids go right)."""
    dev = x.device
    x_t = x.to(torch.float32).T.contiguous()                      # (d, n)
    sf = torch.as_tensor(split_feat, device=dev).to(torch.int64)
    th = torch.as_tensor(threshold, device=dev).to(torch.float32)
    val = torch.as_tensor(value, device=dev).to(torch.float32)
    T, total = sf.shape
    n = x_t.shape[1]
    depth = int(np.log2(total + 1)) - 1
    if cat_flags is not None:
        # host arrays (a model's uint32 masks) or the device tensors of
        # ``device_tree_arrays``
        cm = (cat_mask.to(dev, torch.int64) if isinstance(cat_mask, torch.Tensor)
              else torch.as_tensor(np.asarray(cat_mask, dtype=np.int64), device=dev))
        cflags = (cat_flags.to(dev) if isinstance(cat_flags, torch.Tensor)
                  else torch.as_tensor(np.asarray(cat_flags, dtype=bool), device=dev))
    node = torch.zeros((T, n), dtype=torch.int64, device=dev)
    for _ in range(depth):
        f = torch.gather(sf, 1, node)
        is_split = f >= 0
        fs = torch.clamp(f, min=0)
        xv = torch.gather(x_t, 0, fs)
        right = (xv > torch.gather(th, 1, node)).to(torch.int64)
        if cat_flags is not None:
            icat = cflags[fs]
            xr = torch.round(xv)
            xi = torch.clamp(xr, 0, 31).to(torch.int64)
            in_left = ((torch.gather(cm, 1, node) >> xi) & 1) > 0
            in_left = in_left & (xr >= 0) & (xr < 32)
            right = torch.where(icat, (~in_left).to(torch.int64), right)
        node = torch.where(is_split, 2 * node + 1 + right, node)
    V = val.shape[2]
    return torch.gather(val, 1, node[..., None].expand(T, n, V))

"""Out-of-core datasets: rows ≫ device memory (the JAX package's
``parallel/outofcore.py``).

Spark fits run over disk-backed RDD partitions of any size.  Here the
design matrix stays on the host, a numpy array or an ``np.memmap``, and
each pass streams it to the device, or over a mesh, in blocks of
``max_device_rows`` rows: the estimators that train on sufficient
statistics (KMeans, LinearRegression, GaussianMixture, the trees' level
histograms) add up the same statistics block by block, so device memory
stays bounded by the block size while the result matches the resident
fit.

Every block has one shape: the last one is zero-padded with ``w = 0``
rows, which every weighted reduction ignores (the
:class:`~..data.DeviceDataset` contract).  Over a mesh the block's rows
are rounded up to a multiple of the data axis (``block_shape(mesh)``, the
partitioner's ``"rows"`` family) and a block is a
:class:`~.sharding.ShardedDataset`: data shard i holds rows ``[i·b/D,
(i+1)·b/D)`` of the padded block, ``place_dataset``'s layout, and every
model entry of its row holds it too.  A one-entry mesh (no process group)
gives the single-device ``DeviceDataset``.  A fit sums each block's
statistics shard by shard in ascending shard order (:func:`shard_sum`,
``collectives.aggregate_shards``: one gather a block under a process
group) and then over the blocks in block order.

A staged block is D per-shard segments, each laid out ``[x (b/D·d) | w
(b/D) | y (b/D)]``; under a process group a process fills and copies only
the shards it owns.  On the card the copies are double-buffered: two
pinned host staging buffers and, on every card that holds a shard, two
device buffers, each copy issued ``non_blocking`` on that card's own side
stream, so block *i + 1* crosses the link while the consumer's kernels
work on block *i*.  A card holds the segments of the shards its entries
hold, copied in one piece where they are consecutive: mesh entries that
share a card (the virtual ``[cuda:0] * 4``) copy the block once and their
shards are views of its segments.  CUDA events guard both kinds of reuse:
a pinned buffer is refilled only after its last copy to every card has
finished, and a card's buffer is overwritten only after that card's
compute stream is done with the block it held.  So a block handed out on
the cards stays valid until the iterator advances, and a card holds at
most two blocks' shards.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from ..data import DeviceDataset
from ..device import resolve_device
from .collectives import aggregate_shards, gather_shards
from .mesh import DATA_AXIS, Mesh, single_device_mesh
from .partitioner import family as _partitioner_family
from .sharding import ShardedDataset, uses_shards


def add_stats(a: tuple, b: tuple) -> tuple:
    """Element-wise sum of two tuples of statistics tensors — the block
    accumulator every out-of-core estimator shares."""
    return tuple(u + v for u, v in zip(a, b))


def stream_mesh(mesh: Mesh | None = None, device=None) -> Mesh:
    """The mesh an out-of-core pass streams over: ``mesh``, else the
    one-entry mesh of ``device`` (default the card)."""
    if mesh is not None:
        if device is not None:
            raise ValueError("pass a mesh or a device, not both")
        return mesh
    return single_device_mesh(resolve_device(device))


def stream_home(mesh: Mesh) -> torch.device:
    """Where a pass over ``mesh`` sums and solves: this process's first
    local data shard's device (``collectives.gather_shards``' home)."""
    local = mesh.local_data_shards()
    if not local:
        raise ValueError(f"this process owns no data shard of {mesh}")
    return mesh.device(local[0], 0)


def block_shards(blk) -> dict:
    """A block's local data shards, ``{i: DeviceDataset}`` in ascending
    order (a DeviceDataset is shard 0)."""
    if isinstance(blk, DeviceDataset):
        return {0: blk}
    return {i: blk.shard(i) for i in blk.mesh.local_data_shards()}


def shard_sum(blk, fn) -> tuple:
    """``fn(i, shard)`` (a sequence of tensors) once a local data shard of
    ``blk``, each statistic summed over the data shards in ascending order
    on the home device (``collectives.aggregate_shards``).  A
    DeviceDataset is one shard, and its statistics are ``fn``'s own."""
    if isinstance(blk, DeviceDataset):
        return tuple(fn(0, blk))
    return tuple(aggregate_shards(lambda i: tuple(fn(i, blk.shard(i))), blk.mesh))


def shard_rows(blk, fn) -> np.ndarray:
    """``fn(i, shard)`` (a row-aligned tensor) on every data shard of
    ``blk``, on the host in row order: the shards' parts concatenated in
    data-shard order (gathered over the process group when one is
    active)."""
    if isinstance(blk, DeviceDataset):
        return fn(0, blk).cpu().numpy()
    parts: list = [None] * blk.mesh.shape[DATA_AXIS]
    for i, s in block_shards(blk).items():
        parts[i] = fn(i, s)
    return torch.cat([p.cpu() for p in gather_shards(parts, blk.mesh)]).numpy()


def block_moments(x, y, w, extra: str = "none") -> tuple:
    """One streamed block's standardization moments: (Σw, Σw·x, Σw·x²[,
    extra]).  Features of w = 0 rows are masked before any product (pad
    rows stay inert, NaN or not).  ``extra="ysum"`` appends Σw·y (summed
    by ``add_stats``); ``"ymax"`` the largest valid y (the caller takes
    the max over shards and blocks, not the sum)."""
    x = x.to(torch.float32)
    w = w.to(torch.float32)
    xm = torch.where(w[:, None] > 0, x, torch.zeros_like(x))
    base = (w.sum(), (xm * w[:, None]).sum(dim=0), (xm * xm * w[:, None]).sum(dim=0))
    if extra == "ysum":
        return base + ((y.to(torch.float32) * w).sum(),)
    if extra == "ymax":
        yv = y.to(torch.float32)
        return base + (torch.where(w > 0, yv, torch.zeros_like(yv)).max(),)
    return base


def streamed_standardization(hd, mesh: Mesh | None = None, extra: str = "none", device=None):
    """The moments pre-pass over ``hd``'s blocks on ``mesh`` (or on
    ``device``, default the card) → (n, mean, std, extra), host numpy in
    float32 as the JAX package forms them.

    The one copy of the out-of-core standardization (the logistic, GLM
    and SVC fits consume it), with ``weighted_moments``' degenerate-variance
    rule: a (near-)constant feature gets std 1.0, so the L2 penalty applies
    at full strength.  Each block's moments are summed over its shards in
    ascending shard order, then over the blocks.  ``extra``: "ysum" →
    Σw·y, "ymax" → the largest valid y (a running max over shards and
    blocks on the home device, read once with the sums), "none" → None."""
    mesh = stream_mesh(mesh, device)
    tot = None
    ymax = None
    for blk in hd.blocks(mesh):
        mom = {i: block_moments(s.x, s.y, s.w, extra=extra)
               for i, s in block_shards(blk).items()}
        if extra == "ymax":
            parts: list = [None] * mesh.shape[DATA_AXIS]
            for i, m in mom.items():
                parts[i] = m[3].reshape(1)
                mom[i] = m[:3]
            top = parts[0][0] if isinstance(blk, DeviceDataset) else torch.cat(
                gather_shards(parts, mesh)).max()
            ymax = top if ymax is None else torch.maximum(ymax, top)
        s = shard_sum(blk, lambda i, sh: mom[i])
        tot = s if tot is None else add_stats(tot, s)
    if extra == "ymax":
        tot = tot + (ymax,)
    # one copy to the host: the sums (and y's) flattened into one tensor
    d = hd.n_features
    flat = torch.cat([v.reshape(-1) for v in tot]).cpu().numpy()
    parts = [flat[0], flat[1:1 + d], flat[1 + d:1 + 2 * d], *flat[1 + 2 * d:]]
    sw, sx, sxx = parts[0], parts[1], parts[2]
    n = max(float(sw), 1.0)
    mean = sx / n
    var = np.maximum(sxx / n - mean * mean, 0.0)
    std = np.where(var > 1e-12, np.sqrt(np.maximum(var, 1e-12)), 1.0)
    if extra == "ymax":
        return n, mean, std, max(float(parts[3]), 0.0)
    if extra == "ysum":
        return n, mean, std, float(parts[3])
    return n, mean, std, None


def standardized_ridge(n: float, std: np.ndarray, reg_param: float, nfeat: int,
                       fit_intercept: bool, standardize: bool) -> np.ndarray:
    """Spark's standardized-L2 ridge vector (intercept unpenalized) from the
    streamed moments: the out-of-core counterpart of
    ``standardized_design``'s ridge."""
    scale = std if standardize else np.ones_like(std)
    dd = nfeat + (1 if fit_intercept else 0)
    ridge = np.zeros((dd,), np.float32)
    ridge[:nfeat] = reg_param * n * scale * scale
    return ridge


class _Layout:
    """Where a block's shards go on ``mesh``: the local data shards (their
    segments, in this order, make the staged block), and per device the
    shards its local entries hold (its buffer's segments, ascending) with
    the runs that copy them from the staged block (``(staged position,
    buffer position, segments)``)."""

    def __init__(self, mesh: Mesh, b: int, seg: int, sharded: bool):
        D, M = mesh.devices.shape
        self.mesh, self.b, self.seg = mesh, b, seg
        self.D, self.M, self.per = D, M, b // D
        self.local = mesh.local_data_shards()
        if not self.local:
            raise ValueError(f"this process owns no data shard of {mesh}")
        self.sharded = sharded
        need: dict = {}
        for i in self.local:
            for j in range(M):
                if mesh.is_local(i, j):
                    shards = need.setdefault(mesh.device(i, j), [])
                    if i not in shards:
                        shards.append(i)
        self.need = {dev: sorted(s) for dev, s in need.items()}
        at = {i: p for p, i in enumerate(self.local)}
        self.runs: dict = {}
        for dev, shards in self.need.items():
            runs = []
            for q, i in enumerate(shards):
                if runs and at[i] == runs[-1][0] + runs[-1][2] and q == runs[-1][1] + runs[-1][2]:
                    runs[-1][2] += 1
                else:
                    runs.append([at[i], q, 1])
            self.runs[dev] = [tuple(r) for r in runs]


@dataclass
class HostDataset:
    """A host-resident (possibly memory-mapped) design matrix streamed to
    the device, or over a mesh, in ``max_device_rows``-row blocks.

    ``x``: (n, d) features, ``np.ndarray`` or ``np.memmap``; ``y``:
    optional (n,) labels; ``w``: optional (n,) non-negative sample weights
    (Spark's ``weightCol``).  ``max_device_rows`` bounds how many rows are
    on the devices at once."""

    x: np.ndarray
    y: np.ndarray | None = None
    w: np.ndarray | None = None
    max_device_rows: int = 1 << 20

    def __post_init__(self):
        if self.x.ndim != 2:
            raise ValueError(f"HostDataset.x must be (n, d); got {self.x.shape}")
        for name in ("y", "w"):
            v = getattr(self, name)
            if v is not None and v.shape[0] != self.x.shape[0]:
                raise ValueError(
                    f"HostDataset.{name} has {v.shape[0]} rows but x has "
                    f"{self.x.shape[0]}"
                )
        # a negative weight silently flips reductions: refuse it here, on
        # every estimator's out-of-core path at once
        if self.w is not None and np.any(np.asarray(self.w) < 0):
            raise ValueError("sample weights must be non-negative")
        if self.max_device_rows < 1:
            raise ValueError("max_device_rows must be >= 1")

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def n_features(self) -> int:
        return self.x.shape[1]

    def count(self) -> float:
        return float(np.sum(self.w)) if self.w is not None else float(self.n)

    def block_shape(self, mesh: Mesh | None = None) -> tuple[int, int]:
        """(n_blocks, rows per block); every block crosses at this shape.

        A block holds ``min(max_device_rows, max(n, 1))`` rows, rounded up
        over ``mesh`` to a multiple of its data axis (the JAX package's
        rule, the partitioner's ``"rows"`` family).  ``mesh=None`` is one
        device: no rounding.  With ``max_device_rows`` a multiple of the
        data axis and n at least that, one device and the mesh cut the
        same blocks, which matters where a draw is shaped by the block
        (the forest's per-block bootstrap)."""
        b = min(self.max_device_rows, max(self.n, 1))
        if mesh is not None:
            b = _partitioner_family("rows").round_rows(b, mesh)
        return -(-self.n // b), b

    def sample_rows(self, size: int, seed: int) -> np.ndarray:
        """A uniform host sample of ≤ ``size`` valid (w > 0) rows as
        float64: ``default_rng(seed).choice`` without replacement, sorted
        (the draw of ``data.sample_valid_rows``)."""
        if self.w is not None:
            idx = np.flatnonzero(np.asarray(self.w) > 0)
        else:
            idx = np.arange(self.n)
        if idx.size == 0:
            return np.empty((0, self.n_features), dtype=np.float64)
        if idx.size > size:
            rng = np.random.default_rng(seed)
            idx = np.sort(rng.choice(idx, size=size, replace=False))
        return np.asarray(self.x[idx], dtype=np.float64)

    def _width(self, rows: int) -> int:
        """Values a staged segment of ``rows`` rows holds: x (rows·d) and
        w (rows), and y (rows) when there are labels."""
        return rows * (self.n_features + 1 + (self.y is not None))

    def _fill(self, seg: np.ndarray, s: int, rows: int) -> None:
        """Rows ``[s, s + rows)`` into ``seg`` = [x (rows·d) | w (rows) | y
        (rows)], numpy doing each cast as the JAX package's
        ``pad_block_host`` does; the rows past n are zeros (w = 0)."""
        d = self.n_features
        e = min(s + rows, self.n)
        m = max(e - s, 0)
        xs = seg[: rows * d].reshape(rows, d)
        ws = seg[rows * d : rows * d + rows]
        np.copyto(xs[:m], self.x[s:s + m], casting="unsafe")
        xs[m:] = 0
        if self.w is not None:
            np.copyto(ws[:m], self.w[s:s + m], casting="unsafe")
        else:
            ws[:m] = 1
        ws[m:] = 0
        if self.y is not None:
            ys = seg[rows * d + rows :]
            np.copyto(ys[:m], self.y[s:s + m], casting="unsafe")
            ys[m:] = 0

    def _views(self, seg: torch.Tensor, rows: int) -> DeviceDataset:
        """A segment's tensors as views of ``seg``; without labels ``y``
        is a stride-0 view of one zero (nothing to stage or copy)."""
        d = self.n_features
        if self.y is not None:
            y = seg[rows * d + rows :]
        else:
            y = torch.zeros((1,), dtype=seg.dtype, device=seg.device).expand(rows)
        return DeviceDataset(x=seg[: rows * d].view(rows, d), y=y,
                             w=seg[rows * d : rows * d + rows])

    def _stage(self, lay: _Layout, host: np.ndarray, i: int) -> None:
        """Block ``i``'s local shards into the staged buffer ``host``."""
        for p, t in enumerate(lay.local):
            self._fill(host[p * lay.seg:(p + 1) * lay.seg], i * lay.b + t * lay.per, lay.per)

    def _block(self, lay: _Layout, bufs: dict):
        """The block over ``lay.mesh`` from each device's buffer: entry
        (i, j) a view of shard i's segment on its device (a device holds a
        shard once); the (0, 0) DeviceDataset on a one-entry mesh with no
        process group."""
        mesh = lay.mesh
        blocks = np.empty((lay.D, lay.M), dtype=object)
        views: dict = {}
        for i in lay.local:
            for j in range(lay.M):
                if not mesh.is_local(i, j):
                    continue
                dev = mesh.device(i, j)
                if (dev, i) not in views:
                    q = lay.need[dev].index(i)
                    views[dev, i] = self._views(bufs[dev][q * lay.seg:(q + 1) * lay.seg],
                                                lay.per)
                blocks[i, j] = views[dev, i]
        if not lay.sharded:
            return blocks[0, 0]
        return ShardedDataset(mesh, blocks)

    def blocks(self, mesh: Mesh | None = None, dtype=np.float32, order=None,
               device=None) -> Iterator:
        """Stream the table as fixed-shape blocks over ``mesh`` (each a
        ShardedDataset; a one-entry mesh with no process group gives its
        device's DeviceDataset), or on ``device`` (default the card)
        without one.

        ``order`` (optional permutation of block indices) reorders the
        stream; the sufficient-statistics consumers sum, so they leave it
        None.  On the CPU each block is a fresh tensor; on the cards a
        block lives in one of two reused buffers a card and is valid until
        the iterator advances."""
        sm = stream_mesh(mesh, device)
        n_blocks, b = self.block_shape(mesh)
        if n_blocks == 0:  # empty dataset: no phantom all-pad block
            return
        seq = list(range(n_blocks)) if order is None else [int(i) for i in order]
        # a process group makes a mesh's blocks sharded, not a device's
        lay = _Layout(sm, b, self._width(b // sm.shape[DATA_AXIS]),
                      mesh is not None and uses_shards(mesh))
        if all(dev.type == "cpu" for dev in lay.need):
            for i in seq:
                flat = np.empty((len(lay.local) * lay.seg,), dtype=dtype)
                self._stage(lay, flat, i)
                t = torch.from_numpy(flat)
                yield self._block(lay, {dev: t for dev in lay.need})
            return
        yield from self._stream(lay, seq, dtype)

    def _stream(self, lay: _Layout, seq, dtype) -> Iterator:
        """The cards' double buffer: block ``seq[p + 1]`` is filled and its
        copies issued on each card's side stream before block ``seq[p]``
        is handed to the consumer."""
        tdt = torch.from_numpy(np.empty((0,), dtype=dtype)).dtype
        seg = lay.seg
        devs = list(lay.need)
        # pin_memory raises where the host cannot pin: no pageable fallback
        staged = [torch.empty((len(lay.local) * seg,), dtype=tdt, pin_memory=True)
                  for _ in range(2)]
        on_dev = [{dev: torch.empty((len(lay.need[dev]) * seg,), dtype=tdt, device=dev)
                   for dev in devs} for _ in range(2)]
        copy_stream = {dev: torch.cuda.Stream(dev) for dev in devs}
        compute = {dev: torch.cuda.current_stream(dev) for dev in devs}
        for dev in devs:
            # ``on_dev`` was allocated on the compute stream, maybe from memory
            # that work still queued there reads (the previous stream's last
            # block): the side stream writes it only after that work
            copy_stream[dev].wait_stream(compute[dev])
        copied: list = [{}, {}]    # slot → {card: event after the slot's last copy}
        consumed: list = [{}, {}]  # slot → {card: event after the consumer's work}

        def issue(slot: int, i: int) -> None:
            for ev in copied[slot].values():
                ev.synchronize()                  # its pinned buffer is free
            self._stage(lay, staged[slot].numpy(), i)
            for dev in devs:
                cs = copy_stream[dev]
                with torch.cuda.stream(cs):
                    if dev in consumed[slot]:     # the card's buffer is free
                        cs.wait_event(consumed[slot][dev])
                    for src, dst, cnt in lay.runs[dev]:
                        on_dev[slot][dev][dst * seg:(dst + cnt) * seg].copy_(
                            staged[slot][src * seg:(src + cnt) * seg], non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(cs)
                    copied[slot][dev] = ev

        try:
            issue(0, seq[0])
            for p in range(len(seq)):
                slot = p % 2
                if p + 1 < len(seq):
                    issue(1 - slot, seq[p + 1])
                for dev in devs:
                    compute[dev].wait_event(copied[slot][dev])
                yield self._block(lay, on_dev[slot])
                for dev in devs:
                    ev = torch.cuda.Event()
                    ev.record(compute[dev])
                    consumed[slot][dev] = ev
        finally:
            # a stream closed early may leave a copy in flight: order each
            # compute stream (which frees the buffers) after it, and let the
            # pinned buffers go only once their copies are done
            for slot_events in copied:
                for dev, ev in slot_events.items():
                    compute[dev].wait_event(ev)
                    ev.synchronize()


__all__ = ["HostDataset", "add_stats", "block_moments", "block_shards", "shard_rows",
           "shard_sum", "standardized_ridge", "stream_home", "stream_mesh",
           "streamed_standardization"]

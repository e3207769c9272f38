"""Out-of-core datasets: rows ≫ device memory (the JAX package's
``parallel/outofcore.py`` on one CUDA device).

Spark fits run over disk-backed RDD partitions of any size.  Here the
design matrix stays on the host, a numpy array or an ``np.memmap``, and
each pass streams it to the device in blocks of ``max_device_rows`` rows:
the estimators that train on sufficient statistics (KMeans,
LinearRegression, GaussianMixture, the trees' level histograms) add up
the same statistics block by block, so device memory stays bounded by
the block size while the result matches the resident fit.

Every block has one shape: the last one is zero-padded with ``w = 0``
rows, which every weighted reduction ignores (the
:class:`~..data.DeviceDataset` contract).

On the card the copies are double-buffered: two pinned host staging
buffers and two device buffers, each copy issued ``non_blocking`` on a
side stream, so block *i + 1* crosses the link while the consumer's
kernels work on block *i*.  CUDA events guard both kinds of reuse: a
pinned buffer is refilled only after its last copy has finished, and a
device buffer is overwritten only after the compute stream is done with
the block it held.  So a block handed out on the card stays valid until
the iterator advances.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from ..data import DeviceDataset
from ..device import resolve_device


def add_stats(a: tuple, b: tuple) -> tuple:
    """Element-wise sum of two tuples of statistics tensors — the block
    accumulator every out-of-core estimator shares."""
    return tuple(u + v for u, v in zip(a, b))


def block_moments(x, y, w, extra: str = "none") -> tuple:
    """One streamed block's standardization moments: (Σw, Σw·x, Σw·x²[,
    extra]).  Features of w = 0 rows are masked before any product (pad
    rows stay inert, NaN or not).  ``extra="ysum"`` appends Σw·y (summed
    by ``add_stats``); ``"ymax"`` the largest valid y (the caller takes
    the max over blocks, not the sum)."""
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


def streamed_standardization(hd, device, extra: str = "none"):
    """The moments pre-pass over ``hd``'s blocks on ``device`` → (n, mean,
    std, extra), host numpy in float32 as the JAX package forms them.

    The one copy of the out-of-core standardization (the logistic and SVC
    fits consume it), with ``weighted_moments``' degenerate-variance rule:
    a (near-)constant feature gets std 1.0, so the L2 penalty applies at
    full strength.  ``extra``: "ysum" → Σw·y, "ymax" → the largest valid
    y (a running max on the device, read once with the sums), "none" →
    None."""
    tot = None
    ymax = None
    for blk in hd.blocks(device=device):
        s = block_moments(blk.x, blk.y, blk.w, extra=extra)
        if extra == "ymax":
            ymax = s[3] if ymax is None else torch.maximum(ymax, s[3])
            s = s[:3]
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


@dataclass
class HostDataset:
    """A host-resident (possibly memory-mapped) design matrix streamed to
    the device in ``max_device_rows``-row blocks.

    ``x``: (n, d) features, ``np.ndarray`` or ``np.memmap``; ``y``:
    optional (n,) labels; ``w``: optional (n,) non-negative sample weights
    (Spark's ``weightCol``).  ``max_device_rows`` bounds how many rows are
    on the device at once."""

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

    def block_shape(self) -> tuple[int, int]:
        """(n_blocks, rows per block); every block crosses at this shape.

        The port has one device, so a block holds
        ``min(max_device_rows, max(n, 1))`` rows.  The JAX package rounds
        that up to a multiple of its mesh's data shards (8 on its test
        mesh): with ``max_device_rows`` a multiple of 8 and n at least
        that, both packages cut the same blocks, which matters where a
        draw is shaped by the block (the forest's per-block bootstrap)."""
        b = min(self.max_device_rows, max(self.n, 1))
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

    def _width(self, b: int) -> int:
        """Values a staged block holds: x (b·d) and w (b), and y (b) when
        there are labels."""
        return b * (self.n_features + 1 + (self.y is not None))

    def _fill(self, flat: np.ndarray, i: int, b: int) -> None:
        """Block ``i`` into ``flat`` = [x (b·d) | w (b) | y (b)], numpy
        doing each cast as the JAX package's ``pad_block_host`` does; the
        rows past n are zeros (w = 0)."""
        d = self.n_features
        s = i * b
        e = min(s + b, self.n)
        m = e - s
        xs = flat[: b * d].reshape(b, d)
        ws = flat[b * d : b * d + b]
        np.copyto(xs[:m], self.x[s:e], casting="unsafe")
        xs[m:] = 0
        if self.w is not None:
            np.copyto(ws[:m], self.w[s:e], casting="unsafe")
        else:
            ws[:m] = 1
        ws[m:] = 0
        if self.y is not None:
            ys = flat[b * d + b :]
            np.copyto(ys[:m], self.y[s:e], casting="unsafe")
            ys[m:] = 0

    def _views(self, flat: torch.Tensor, b: int) -> DeviceDataset:
        """The block's tensors as views of ``flat``; without labels ``y``
        is a stride-0 view of one zero (nothing to stage or copy)."""
        d = self.n_features
        if self.y is not None:
            y = flat[b * d + b :]
        else:
            y = torch.zeros((1,), dtype=flat.dtype, device=flat.device).expand(b)
        return DeviceDataset(x=flat[: b * d].view(b, d), y=y, w=flat[b * d : b * d + b])

    def blocks(self, device=None, dtype=np.float32, order=None) -> Iterator[DeviceDataset]:
        """Stream the table as fixed-shape blocks on ``device`` (default
        the card).

        ``order`` (optional permutation of block indices) reorders the
        stream; the sufficient-statistics consumers sum, so they leave it
        None.  On the CPU each block is a fresh tensor; on the card a
        block lives in one of two reused device buffers and is valid until
        the iterator advances."""
        dev = resolve_device(device)
        n_blocks, b = self.block_shape()
        if n_blocks == 0:  # empty dataset: no phantom all-pad block
            return
        seq = list(range(n_blocks)) if order is None else [int(i) for i in order]
        if dev.type == "cpu":
            for i in seq:
                flat = np.empty((self._width(b),), dtype=dtype)
                self._fill(flat, i, b)
                yield self._views(torch.from_numpy(flat), b)
            return
        yield from self._stream(dev, seq, b, dtype)

    def _stream(self, dev, seq, b: int, dtype) -> Iterator[DeviceDataset]:
        """The card's double buffer: block ``seq[p + 1]`` is filled and its
        copy issued on a side stream before block ``seq[p]`` is handed to
        the consumer."""
        tdt = torch.from_numpy(np.empty((0,), dtype=dtype)).dtype
        width = self._width(b)
        # pin_memory raises where the host cannot pin: no pageable fallback
        staged = [torch.empty((width,), dtype=tdt, pin_memory=True) for _ in range(2)]
        on_dev = [torch.empty((width,), dtype=tdt, device=dev) for _ in range(2)]
        copy_stream = torch.cuda.Stream(dev)
        compute = torch.cuda.current_stream(dev)
        copied: list = [None, None]    # event after the slot's last copy
        consumed: list = [None, None]  # event after the consumer's work on it

        def issue(slot: int, i: int) -> None:
            if copied[slot] is not None:
                copied[slot].synchronize()       # its pinned buffer is free
            self._fill(staged[slot].numpy(), i, b)
            with torch.cuda.stream(copy_stream):
                if consumed[slot] is not None:   # its device buffer is free
                    copy_stream.wait_event(consumed[slot])
                on_dev[slot].copy_(staged[slot], non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(copy_stream)
                copied[slot] = ev

        try:
            issue(0, seq[0])
            for p in range(len(seq)):
                slot = p % 2
                if p + 1 < len(seq):
                    issue(1 - slot, seq[p + 1])
                compute.wait_event(copied[slot])
                yield self._views(on_dev[slot], b)
                ev = torch.cuda.Event()
                ev.record(compute)
                consumed[slot] = ev
        finally:
            # a stream closed early may leave a copy in flight: order the
            # compute stream (which frees the buffers) after it, and let the
            # pinned buffers go only once their copies are done
            for ev in copied:
                if ev is not None:
                    compute.wait_event(ev)
                    ev.synchronize()


__all__ = ["HostDataset", "add_stats", "block_moments", "standardized_ridge",
           "streamed_standardization"]

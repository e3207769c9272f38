"""Single-device datasets: host numpy → padded, weighted tensors.

The port's counterpart of the JAX package's ``parallel/sharding.py``
``DeviceDataset`` on one device.  Rows are padded (an empty input gets one
pad row) and an explicit weight column marks validity: pad rows carry
w = 0, so every weighted reduction ignores them — the contract the Lloyd
kernels and the evaluators rely on.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .device import resolve_device


def padded_slots(count: int, multiple: int) -> int:
    """Smallest slot-axis length >= count divisible by ``multiple``."""
    return -(-count // multiple) * multiple


def slot_mask(n_valid: int, n_total: int, dtype=np.float32) -> np.ndarray:
    """0/1 validity mask over a padded slot axis: ``[:n_valid] = 1``."""
    m = np.zeros((n_total,), dtype=dtype)
    m[:n_valid] = 1.0
    return m


def pad_slots(arr: np.ndarray, n_total: int, dtype=np.float32) -> np.ndarray:
    """Zero-extend ``arr`` along axis 0 to ``n_total`` slots (host-side)."""
    arr = np.asarray(arr, dtype=dtype)
    out = np.zeros((n_total,) + arr.shape[1:], dtype=dtype)
    out[: arr.shape[0]] = arr
    return out


def stack_ragged(mats, weights=None, pad_to: int | None = None, dtype=np.float32):
    """Ragged row blocks → one padded stack + weight mask (host numpy).

    ``mats`` is B arrays of shape (n_b, d); the result is ``(xs, ws)``
    with ``xs`` of shape (B, R, d) and ``ws`` of shape (B, R), where
    ``R = pad_to or max(n_b)``.  Rows past each block's length get weight
    0 — the pad-and-weight contract along a leading tenant axis.
    ``weights`` (optional per-block row weights) fold into the mask;
    otherwise valid rows get weight 1."""
    B = len(mats)
    if B == 0:
        raise ValueError("stack_ragged needs at least one block")
    d = mats[0].shape[1] if mats[0].ndim == 2 else 1
    R = pad_to if pad_to is not None else max(int(m.shape[0]) for m in mats)
    R = max(R, 1)
    xs = np.empty((B, R, d), dtype=dtype)
    ws = np.zeros((B, R), dtype=dtype)
    for i, m in enumerate(mats):
        n = int(m.shape[0])
        if n > R:
            raise ValueError(f"block {i} has {n} rows > padded length {R}")
        xs[i, :n] = m.reshape(n, d)
        xs[i, n:] = 0.0
        if weights is not None:
            ws[i, :n] = np.asarray(weights[i], dtype=dtype).reshape(-1)[:n]
        else:
            ws[i, :n] = 1.0
    return xs, ws


def batch_rows(batch) -> int:
    """Row count of any streaming batch form — array or tensor, (x, y[, w])
    tuple, Table, AssembledTable, DeviceDataset — without copying device
    tensors to the host (host code, copied from the JAX package's
    ``parallel/sharding.py``)."""
    if isinstance(batch, tuple):
        batch = batch[0]
    shape = getattr(batch, "shape", None)
    if shape is not None:
        return int(shape[0]) if len(shape) else 1
    n = getattr(batch, "num_rows", None)  # Table
    if n is not None:
        return int(n)
    x = getattr(batch, "x", None)  # DeviceDataset (padded count)
    if x is not None:
        return int(x.shape[0])
    feats = getattr(batch, "features", None)  # AssembledTable
    if feats is not None:
        return int(feats.shape[0])
    return int(np.asarray(batch).shape[0])


@dataclass
class DeviceDataset:
    """A padded, weighted design matrix on one device.

    ``x``: (n_pad, d) float32 features; ``y``: (n_pad,) labels (zeros if
    absent); ``w``: (n_pad,) weights, 0 on pad rows."""

    x: torch.Tensor
    y: torch.Tensor
    w: torch.Tensor

    @property
    def n_padded(self) -> int:
        return self.x.shape[0]

    @property
    def n_features(self) -> int:
        return self.x.shape[1]

    def count(self) -> torch.Tensor:
        """Σw, the valid rows' weight, as a 0-d tensor on the device."""
        return torch.sum(self.w)


def device_dataset(
    x: np.ndarray,
    y: np.ndarray | None = None,
    device=None,
    weights: np.ndarray | None = None,
) -> DeviceDataset:
    """Pad a host design matrix and move it to ``device`` (default the
    card).  The float32 conversion happens in numpy, as in the JAX
    package, so both hold bit-equal features.  ``weights`` are optional
    non-negative per-row sample weights folded into ``w``."""
    dev = resolve_device(device)
    x = np.atleast_2d(np.asarray(x))
    n = x.shape[0]
    n_pad = max(n, 1)  # an empty input keeps one (weight-0) pad row
    xp = np.zeros((n_pad, x.shape[1]), dtype=np.float32)
    xp[:n] = x
    if weights is not None:
        wh = np.asarray(weights, dtype=np.float64).reshape(-1)
        if wh.shape[0] != n:
            raise ValueError(f"weights length {wh.shape[0]} != number of rows {n}")
        if np.any(wh < 0):
            raise ValueError("sample weights must be non-negative")
        wp = np.zeros((n_pad,), dtype=np.float32)
        wp[:n] = wh
        w = torch.from_numpy(wp).to(dev)
    else:
        w = (torch.arange(n_pad, device=dev) < n).to(torch.float32)
    yp = np.zeros((n_pad,), dtype=np.float32)
    if y is not None:
        yp[:n] = np.asarray(y).reshape(-1)
    return DeviceDataset(
        x=torch.from_numpy(xp).to(dev), y=torch.from_numpy(yp).to(dev), w=w
    )


def unpad(values: torch.Tensor, n: int) -> np.ndarray:
    """A row-aligned device result on the host with padding stripped."""
    return values[:n].cpu().numpy()


def sample_valid_rows(ds: DeviceDataset, size: int, seed: int) -> np.ndarray:
    """A uniform sample of ≤ ``size`` valid rows on the host, as float64.

    The same draw as the JAX package: ``default_rng(seed).choice`` over
    the valid row indices without replacement, then sorted; only the
    weights and the sampled rows leave the device."""
    w = ds.w.cpu().numpy()
    valid_idx = np.flatnonzero(w > 0)
    if valid_idx.size == 0:
        return np.empty((0, ds.n_features), dtype=np.float64)
    if valid_idx.size > size:
        rng = np.random.default_rng(seed)
        valid_idx = np.sort(rng.choice(valid_idx, size=size, replace=False))
    rows = ds.x[torch.from_numpy(valid_idx).to(ds.x.device)]
    return rows.cpu().numpy().astype(np.float64)

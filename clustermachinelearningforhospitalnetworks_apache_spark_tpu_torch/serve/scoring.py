"""Bulk scoring: large jobs in canonical chunks, on one device or over a
mesh.

The offline half of the serving layer (MLlib's batch ``transform``):
rows go to the device one fixed-size chunk at a time — the last chunk
padded up to the same shape — and only the predictions come back, so a
10M-row job never holds more than one chunk of rows on the card.

Over a mesh (``mesh=``, the JAX package's ``serve/scoring.py``) each chunk
is laid out over the data axis as training lays out its rows
(``parallel.sharding.device_dataset``), the model predicts shard by shard
on each shard's device (KMeans: one K2 launch a shard), and the pad rows
are sliced off on the way out.  Chunks are rounded up to a multiple of
the data axis by the ``"rows"`` family's ``round_rows``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..models.base import Model
from ..parallel.partitioner import family
from ..parallel.sharding import MeshArray, device_dataset, unpad

#: default rows per scoring chunk (a multiple of any data axis that
#: divides a power of two)
DEFAULT_CHUNK_ROWS = 262_144


def _placement(mesh, device):
    """Where a chunk of host rows goes: one tensor on ``device`` (default
    the card), or a row-sharded MeshArray over ``mesh`` (not both)."""
    if mesh is None:
        dev = resolve_device(device)
        return lambda piece: torch.from_numpy(piece).to(dev)
    if device is not None:
        raise ValueError("pass a mesh or a device, not both")
    return lambda piece: device_dataset(piece, mesh=mesh).x


def _score(fn, x: np.ndarray, chunk: int, place) -> np.ndarray:
    """``fn`` over host rows ``x`` in chunks of ``chunk`` rows, the tail
    padded to the same shape: ``place`` puts each chunk where it is
    predicted (a MeshArray shard by shard), and the pad rows are sliced
    off on the way out."""
    n, d = x.shape
    out = None
    for s in range(0, n, chunk):
        piece = np.ascontiguousarray(x[s : s + chunk], dtype=np.float32)
        m = piece.shape[0]
        if m < chunk:  # tail: pad to the canonical shape
            piece = np.concatenate([piece, np.zeros((chunk - m, d), np.float32)])
        rows = place(piece)
        got = unpad(rows.map_data(fn) if isinstance(rows, MeshArray) else fn(rows), m)
        if out is None:
            out = np.empty((n,), dtype=got.dtype)
        out[s : s + m] = got
    return out if out is not None else np.empty((0,), dtype=np.int32)


def bulk_score(
    model: Model,
    x: np.ndarray,
    mesh: Any | None = None,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
    device: Any = None,
) -> np.ndarray:
    """Score host rows ``x`` (n, d) on ``device`` (default the card), or
    over ``mesh`` (not both), returning (n,) predictions.  Jobs up to
    ``chunk_rows`` go in one call; larger ones stream through
    ``chunk_rows``-row chunks (over a mesh rounded up to a multiple of the
    data axis)."""
    x = np.atleast_2d(np.asarray(x))
    place = _placement(mesh, device)
    n = x.shape[0]
    if n <= chunk_rows:
        chunk = max(n, 1)
    else:
        chunk = chunk_rows if mesh is None else family("rows").round_rows(chunk_rows, mesh)
    return _score(model.serving_predict_fn(), x, chunk, place)


class ShardedScorer:
    """Reusable bulk scorer: one model, one device or mesh, one chunk
    shape.  Every job, large or small, streams through the same canonical
    chunk shape (over a mesh, ``chunk_rows`` rounded up to a multiple of
    the data axis)."""

    def __init__(self, model: Model, mesh: Any | None = None,
                 chunk_rows: int = DEFAULT_CHUNK_ROWS, device: Any = None):
        self.model = model
        self.mesh = mesh
        self._place = _placement(mesh, device)
        self.device = None if mesh is not None else resolve_device(device)
        self.chunk_rows = (int(chunk_rows) if mesh is None
                           else family("rows").round_rows(chunk_rows, mesh))
        self._fn = model.serving_predict_fn()

    def warmup(self) -> "ShardedScorer":
        d = self.model.num_features
        if d is None:
            return self
        if self.mesh is None:  # zeros made on the device: no copy either way
            self._fn(torch.zeros((self.chunk_rows, d), device=self.device))
        else:
            self.score(np.zeros((self.chunk_rows, d), np.float32))
        return self

    def score(self, x: np.ndarray) -> np.ndarray:
        return _score(self._fn, np.atleast_2d(np.asarray(x)), self.chunk_rows, self._place)

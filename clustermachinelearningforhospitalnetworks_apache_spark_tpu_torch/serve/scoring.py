"""Bulk scoring: large jobs through one device in canonical chunks.

The offline half of the serving layer (MLlib's batch ``transform``):
rows go to the device one fixed-size chunk at a time — the last chunk
padded up to the same shape — and only the predictions come back, so a
10M-row job never holds more than one chunk of rows on the card.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..models.base import Model

#: default rows per scoring chunk
DEFAULT_CHUNK_ROWS = 262_144


def _score_chunks(fn, x: np.ndarray, device: torch.device, chunk: int) -> np.ndarray:
    n, d = x.shape
    out = None
    for s in range(0, n, chunk):
        piece = np.ascontiguousarray(x[s : s + chunk], dtype=np.float32)
        m = piece.shape[0]
        if m < chunk:  # tail: pad to the canonical shape
            piece = np.concatenate([piece, np.zeros((chunk - m, d), np.float32)])
        got = fn(torch.from_numpy(piece).to(device))[:m].cpu().numpy()
        if out is None:
            out = np.empty((n,), dtype=got.dtype)
        out[s : s + m] = got
    return out if out is not None else np.empty((0,), dtype=np.int32)


def bulk_score(
    model: Model,
    x: np.ndarray,
    device: Any = None,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
) -> np.ndarray:
    """Score host rows ``x`` (n, d) on ``device`` (default the card),
    returning (n,) predictions.  Jobs up to ``chunk_rows`` go in one call;
    larger ones stream through ``chunk_rows``-row chunks."""
    dev = resolve_device(device)
    x = np.atleast_2d(np.asarray(x))
    return _score_chunks(
        model.serving_predict_fn(), x, dev, max(1, min(chunk_rows, x.shape[0]))
    )


class ShardedScorer:
    """Reusable bulk scorer: one model, one device, one chunk shape.
    Every job, large or small, streams through the same canonical chunk
    shape."""

    def __init__(self, model: Model, device: Any = None,
                 chunk_rows: int = DEFAULT_CHUNK_ROWS):
        self.model = model
        self.device = resolve_device(device)
        self.chunk_rows = int(chunk_rows)
        self._fn = model.serving_predict_fn()

    def warmup(self) -> "ShardedScorer":
        d = self.model.num_features
        if d is not None:
            self._fn(torch.zeros((self.chunk_rows, d), device=self.device))
        return self

    def score(self, x: np.ndarray) -> np.ndarray:
        return _score_chunks(
            self._fn, np.atleast_2d(np.asarray(x)), self.device, self.chunk_rows
        )

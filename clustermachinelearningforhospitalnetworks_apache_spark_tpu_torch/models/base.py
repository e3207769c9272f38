"""Estimator / Model protocol (the JAX package's ``models/base.py``).

Estimators consume a padded :class:`~..data.DeviceDataset` (or anything
coercible to one) and models predict on the device the input lies on.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..data import DeviceDataset, device_dataset, unpad
from ..device import resolve_device
from ..features.assembler import AssembledTable


def as_device_dataset(data: Any, device=None) -> DeviceDataset:
    """Coerce (DeviceDataset | AssembledTable | (X, y[, w]) | X) to a
    padded dataset on ``device`` (default the card).  A DeviceDataset is
    returned as it is, on its own device."""
    if isinstance(data, DeviceDataset):
        return data
    if isinstance(data, AssembledTable):
        return data.to_device(device=device)
    if isinstance(data, tuple) and len(data) == 3:
        return device_dataset(np.asarray(data[0]), np.asarray(data[1]),
                              device=device, weights=np.asarray(data[2]))
    if isinstance(data, tuple) and len(data) == 2:
        return device_dataset(np.asarray(data[0]), np.asarray(data[1]),
                              device=device)
    return device_dataset(np.asarray(data), None, device=device)


class Estimator:
    """Base: subclasses implement ``fit(dataset, device=...) -> Model``."""

    def fit(self, data: Any, device=None):
        raise NotImplementedError


def check_features(x, expected: int, model_name: str) -> None:
    """Friendly feature-width validation at the model's front door."""
    got = x.shape[-1] if getattr(x, "ndim", 0) >= 2 else None
    if got is not None and got != expected:
        raise ValueError(
            f"{model_name} was trained on {expected} features but the input "
            f"has {got} (shape {tuple(x.shape)}); assemble the same feature "
            "columns used at fit time"
        )


class Model:
    """Base: subclasses implement ``predict(x) -> Tensor`` on x's device."""

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def serving_predict_fn(self):
        """Stable raw-tensor predict entry point for the ``serve/`` layer:
        ``(batch, d) tensor -> (batch,)`` predictions, deterministic and
        row-local (row i of the output depends only on row i of the
        input), so the server may pad batches and slice real rows back."""
        return self.predict

    @property
    def num_features(self) -> int | None:
        """Feature width the model was trained on, when recoverable."""
        centers = getattr(self, "cluster_centers", None)
        return None if centers is None else int(np.asarray(centers).shape[1])

    def predict_numpy(self, x: np.ndarray, device=None) -> np.ndarray:
        """Host rows in, host predictions out; computed on ``device``
        (default the card)."""
        ds = as_device_dataset(np.asarray(x), device=resolve_device(device))
        n = np.asarray(x).shape[0]
        return unpad(self.predict(ds.x), n)


class ClusteringModel(Model):
    """Model base for the clustering family."""

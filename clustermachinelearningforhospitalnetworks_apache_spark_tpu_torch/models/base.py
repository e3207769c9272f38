"""Estimator / Model protocol (the JAX package's ``models/base.py``).

Estimators consume a padded :class:`~..data.DeviceDataset` (or anything
coercible to one) and models predict on the device the input lies on;
``Model.transform`` returns a :class:`PredictionResult` whose tensors stay
on the device until an evaluator reduces them.  ``Model.save`` and the
Spark-style ``model.write().overwrite().save(path)`` write the JAX
package's artifact layout (``io/model_io.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..data import DeviceDataset, device_dataset, unpad
from ..device import resolve_device
from ..features.assembler import AssembledTable


def as_device_dataset(data: Any, label_col: str | None = None, device=None,
                      weight_col: str | None = None) -> DeviceDataset:
    """Coerce (DeviceDataset | AssembledTable | (X, y[, w]) | X) to a
    padded dataset on ``device`` (default the card).  A DeviceDataset is
    returned as it is, on its own device; an AssembledTable takes its
    labels (``label_col``) and weights (``weight_col``) from its source
    table."""
    if isinstance(data, DeviceDataset):
        return data
    if isinstance(data, AssembledTable):
        return data.to_device(label_col=label_col, device=device, weight_col=weight_col)
    if weight_col is not None:
        raise ValueError(
            f"weight_col={weight_col!r} needs a table input to resolve the "
            f"column; got {type(data).__name__} — pass an AssembledTable, "
            "an (x, y, weights) tuple, or a pre-weighted DeviceDataset"
        )
    if isinstance(data, tuple) and len(data) == 3:
        return device_dataset(np.asarray(data[0]), np.asarray(data[1]),
                              device=device, weights=np.asarray(data[2]))
    if isinstance(data, tuple) and len(data) == 2:
        return device_dataset(np.asarray(data[0]), np.asarray(data[1]),
                              device=device)
    return device_dataset(np.asarray(data), None, device=device)


@dataclass
class PredictionResult:
    """Predictions, labels and validity weights (pad rows w = 0), as
    tensors on the device the model ran on."""

    prediction: torch.Tensor
    label: torch.Tensor
    weight: torch.Tensor

    def to_numpy(self, n: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        pred = self.prediction.cpu().numpy()
        lab = self.label.cpu().numpy()
        if n is None:
            valid = self.weight.cpu().numpy() > 0
            return pred[valid], lab[valid]
        return pred[:n], lab[:n]


class Estimator:
    """Base: subclasses implement ``fit(data, label_col=None, device=None)
    -> Model``."""

    def fit(self, data: Any, label_col: str | None = None, device=None):
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
        """Feature width the model was trained on, when recoverable from
        its parameters — the serve registry sizes its buckets with it."""
        for attr, axis in (
            ("coefficients", -1),         # linear family
            ("cluster_centers", 1),       # kmeans
            ("theta", 1),                 # naive bayes
            ("feature_importances", -1),  # tree ensembles
        ):
            v = getattr(self, attr, None)
            if v is not None and len(getattr(v, "shape", ())) >= 1:
                return int(v.shape[axis])
        return None

    def transform(self, data: Any, label_col: str | None = None,
                  device=None) -> PredictionResult:
        """Predict on ``data`` (coerced as :func:`as_device_dataset`
        does) → predictions beside its labels and weights."""
        ds = as_device_dataset(data, label_col=label_col, device=device)
        return PredictionResult(prediction=self.predict(ds.x), label=ds.y, weight=ds.w)

    def predict_numpy(self, x: np.ndarray, device=None) -> np.ndarray:
        """Host rows in, host predictions out; computed on ``device``
        (default the card)."""
        ds = as_device_dataset(np.asarray(x), device=resolve_device(device))
        n = np.asarray(x).shape[0]
        return unpad(self.predict(ds.x), n)

    # persistence sugar -------------------------------------------------
    def save(self, path: str, overwrite: bool = True) -> None:
        from ..io.model_io import save_model

        name, meta, arrays = self._artifacts()
        save_model(path, name, meta, arrays, overwrite=overwrite)

    def write(self) -> "_Writer":
        """Spark-style ``model.write().overwrite().save(path)`` chain."""
        return _Writer(self)

    def _artifacts(self) -> tuple[str, dict, dict[str, np.ndarray]]:
        """→ (``model_class`` tag, JSON params, numpy payload arrays)."""
        raise NotImplementedError


class ClusteringModel(Model):
    """Model base for the clustering family, adding Spark's DataFrame-style
    ``transform``: an :class:`AssembledTable` comes back as its source
    :class:`Table` with an int ``prediction`` column appended (the
    assignments, computed on ``device``, default the card).  Non-table
    inputs keep the base behavior (:class:`PredictionResult`)."""

    def transform(self, data: Any, label_col: str | None = None, device=None):
        if isinstance(data, AssembledTable):
            pred = self.predict_numpy(data.features, device=device).astype(np.int32)
            return data.table.with_column("prediction", pred, dtype="int")
        return super().transform(data, label_col=label_col, device=device)


@dataclass
class _Writer:
    model: Model
    _overwrite: bool = False

    def overwrite(self) -> "_Writer":
        self._overwrite = True
        return self

    def save(self, path: str) -> None:
        self.model.save(path, overwrite=self._overwrite)

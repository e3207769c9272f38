"""Model registry: fitted model or saved artifact → shape-bucketed
predict on one device.

The online half of ``io/model_io.py``: ``load_model(path)`` rebuilds any
registered family, and :class:`ServingModel` wraps a model's stable raw-tensor predict
(``models/base.py::Model.serving_predict_fn``) behind a fixed ladder of
batch shapes.  Warmup runs every bucket once before traffic — on the card
that builds the kernels and fills the allocator's pools — and a request
shape outside the warmed ladder is counted as a recompile (the number
that must stay 0).
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..io.model_io import load_model
from ..models.base import Model
from ..utils.faults import fault_point
from ..utils.logging import get_logger
from .bucketing import (
    DEFAULT_BUCKETS,
    bucket_for,
    fill_ratio,
    iter_chunks,
    pad_to_bucket,
    validate_buckets,
)
from .metrics import ServingMetrics

log = get_logger("serve")


class ServingModel:
    """A model behind a fixed ladder of batch shapes on one device."""

    def __init__(
        self,
        model: Model,
        n_features: int | None = None,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        metrics: ServingMetrics | None = None,
        device=None,
    ):
        self.model = model
        self.buckets = validate_buckets(buckets)
        self.metrics = metrics or ServingMetrics()
        self.device = resolve_device(device)
        n = n_features if n_features is not None else model.num_features
        if n is None:
            raise ValueError(
                f"{type(model).__name__} does not expose num_features; pass "
                "n_features= explicitly so bucket shapes can be sized"
            )
        self.n_features = int(n)
        self._fn = model.serving_predict_fn()
        self._warmed: set[int] = set()
        self._lock = threading.Lock()

    def _run(self, x: np.ndarray) -> np.ndarray:
        out = self._fn(torch.from_numpy(x).to(self.device))
        return out.cpu().numpy()

    def warmup(self) -> "ServingModel":
        """Run every bucket shape once so steady-state serving meets no
        new shape.  Idempotent; returns self."""
        for b in self.buckets:
            with self._lock:
                if b in self._warmed:
                    continue
                self._warmed.add(b)
            self.metrics.record_compile(b, warm=True)
            self._run(np.zeros((b, self.n_features), dtype=np.float32))
        return self

    def jit_cache_size(self) -> None:
        """Always None: eager torch keeps no compiled executables to count
        (the JAX package reports its jit cache here)."""
        return None

    def predict_bucketed(self, x: np.ndarray) -> np.ndarray:
        """One padded device call: pick the bucket, pad, predict, slice.
        ``x`` must fit the largest bucket; :meth:`predict` splits larger
        inputs."""
        x = np.ascontiguousarray(x, dtype=np.float32)
        if x.ndim == 1:
            x = x[None, :]
        n = x.shape[0]
        # the primary-model fault site: a fault plan fails the model here
        # to drive the batcher's circuit breaker
        fault_point("serve.predict", model=type(self.model).__name__, rows=n)
        b = bucket_for(n, self.buckets)
        with self._lock:
            cold = b not in self._warmed
            self._warmed.add(b)
        if cold:
            self.metrics.record_compile(b, warm=False)
        out = self._run(pad_to_bucket(x, b))
        self.metrics.record_batch(n, b)
        return out[:n]

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Predict any batch size: oversized inputs go through the top
        bucket chunk by chunk."""
        x = np.asarray(x)
        if x.ndim == 1:
            x = x[None, :]
        top = self.buckets[-1]
        if x.shape[0] <= top:
            return self.predict_bucketed(x)
        parts = [self.predict_bucketed(piece) for _, piece in iter_chunks(x, top)]
        return np.concatenate(parts, axis=0)

    def batch_fill(self, n: int) -> float:
        """The share of real rows in the bucket an ``n``-row batch pads to."""
        return fill_ratio(n, bucket_for(n, self.buckets))


class ModelRegistry:
    """Name → :class:`ServingModel`, loadable straight from saved artifact
    directories (``model.save(path)`` → ``registry.load(name, path)``)."""

    def __init__(self, metrics: ServingMetrics | None = None):
        self.metrics = metrics or ServingMetrics()
        self._models: dict[str, ServingModel] = {}
        self._lock = threading.Lock()

    def register(
        self,
        name: str,
        model: Model,
        n_features: int | None = None,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        warmup: bool = False,
        device=None,
    ) -> ServingModel:
        """Wrap ``model`` on ``device`` (default the card) under ``name``;
        ``warmup`` runs every bucket once before it is visible."""
        sm = ServingModel(model, n_features=n_features, buckets=buckets,
                          metrics=self.metrics, device=device)
        if warmup:
            sm.warmup()
        with self._lock:
            self._models[name] = sm
        log.info(
            "model registered", name=name, family=type(model).__name__,
            n_features=sm.n_features, buckets=len(sm.buckets),
        )
        return sm

    def load(
        self,
        name: str,
        path: str,
        n_features: int | None = None,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        warmup: bool = False,
        device=None,
    ) -> ServingModel:
        """``io/model_io.load_model`` + :meth:`register`: any family the
        persistence registry knows goes straight into serving."""
        return self.register(
            name, load_model(path), n_features=n_features,
            buckets=buckets, warmup=warmup, device=device,
        )

    def install(self, name: str, sm: ServingModel) -> ServingModel:
        """Install an already-built (e.g. pre-warmed) :class:`ServingModel`
        under ``name`` — the hot-swap entry point: the previous model keeps
        answering until this one atomic dict swap, so a promotion never
        serves a cold or half-registered model."""
        with self._lock:
            self._models[name] = sm
        log.info(
            "model installed (hot swap)", name=name,
            family=type(sm.model).__name__,
        )
        return sm

    def get(self, name: str) -> ServingModel:
        with self._lock:
            if name not in self._models:
                raise KeyError(
                    f"no model {name!r} in registry; have {sorted(self._models)}"
                )
            return self._models[name]

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._models)

    def warmup_all(self) -> None:
        """Warm every registered model's buckets."""
        for name in self.names():
            self.get(name).warmup()

"""InferenceServer: registry + per-model micro-batchers, one front door.

Register fitted models, ``start()``, then ``predict(name, rows)`` from any
number of client threads.  Each model gets its own :class:`MicroBatcher`
(its own queue and worker) so a slow model cannot head-of-line-block a
fast one; the metrics sink is shared so one ``stats()`` call reports the
whole server.  Every request is answered with one :class:`ServeResult`:
``ok``, ``rejected`` (queue saturated), ``deadline_exceeded``,
``unavailable`` (the model raised) or ``shutdown``.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from ..device import resolve_device
from ..models.base import Model
from .batcher import DEFAULT_MAX_WAIT_S, Fallback, MicroBatcher
from .bucketing import DEFAULT_BUCKETS
from .metrics import ServingMetrics
from .queue import DEFAULT_MAX_QUEUE_ROWS, Request, ServeResult
from .registry import ModelRegistry, ServingModel


class InferenceServer:
    """Online inference over one or more registered models on ``device``
    (default the card)."""

    def __init__(
        self,
        registry: ModelRegistry | None = None,
        max_queue_rows: int = DEFAULT_MAX_QUEUE_ROWS,
        max_wait_s: float = DEFAULT_MAX_WAIT_S,
        device=None,
    ):
        self.registry = registry or ModelRegistry()
        self.device = resolve_device(device)
        self.metrics: ServingMetrics = self.registry.metrics
        self.max_queue_rows = max_queue_rows
        self.max_wait_s = max_wait_s
        self._batchers: dict[str, MicroBatcher] = {}
        self._fallbacks: dict[str, Fallback] = {}
        self._started = False

    def _new_batcher(self, name: str, sm: ServingModel) -> MicroBatcher:
        return MicroBatcher(
            sm, max_queue_rows=self.max_queue_rows, max_wait_s=self.max_wait_s,
            fallback=self._fallbacks.get(name), metrics=self.metrics,
        ).start()

    def add_model(
        self,
        name: str,
        model: Model | str,
        n_features: int | None = None,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        fallback: Fallback = None,
    ) -> ServingModel:
        """Register a fitted model (or a saved-artifact path) for serving;
        ``fallback`` answers this model's degraded requests."""
        # hot-add: warmed before it is registered, then given a batcher
        add = self.registry.load if isinstance(model, str) else self.registry.register
        sm = add(name, model, n_features=n_features, buckets=buckets,
                 warmup=self._started, device=self.device)
        self._fallbacks[name] = fallback
        if self._started:
            self._batchers[name] = self._new_batcher(name, sm)
        return sm

    def start(self) -> "InferenceServer":
        """Warm every bucket, then start the batcher workers — in that
        order, so no request races a warmup."""
        for name in self.registry.names():
            sm = self.registry.get(name)
            sm.warmup()
            if name not in self._batchers:
                self._batchers[name] = self._new_batcher(name, sm)
        self._started = True
        return self

    def stop(self) -> None:
        for b in list(self._batchers.values()):
            b.stop()
        self._batchers.clear()
        self._started = False

    def __enter__(self) -> "InferenceServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _batcher(self, name: str) -> MicroBatcher:
        if name not in self._batchers:
            raise KeyError(
                f"model {name!r} is not being served "
                f"(started={self._started}); have {sorted(self._batchers)}"
            )
        return self._batchers[name]

    def submit(self, name: str, x: np.ndarray,
               deadline_s: float | None = None) -> Request:
        """Admit a request; ``.wait()`` on the returned Request yields the
        :class:`ServeResult`."""
        return self._batcher(name).submit(x, deadline_s=deadline_s)

    def predict(self, name: str, x: np.ndarray, deadline_s: float | None = None,
                wait_timeout_s: float | None = 30.0) -> ServeResult:
        return self.submit(name, x, deadline_s=deadline_s).wait(wait_timeout_s)

    def stats(self) -> dict[str, Any]:
        out = self.metrics.snapshot()
        out["models"] = {
            name: {
                "buckets": list(b.model.buckets),
                "n_features": b.model.n_features,
                "queue_depth_rows": b.queue.depth_rows,
            }
            for name, b in list(self._batchers.items())
        }
        return out

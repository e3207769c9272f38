"""InferenceServer: registry + per-model micro-batchers, one front door.

Register fitted models, ``start()``, then ``predict(name, rows)`` from any
number of client threads.  Each model gets its own :class:`MicroBatcher`
(its own queue and worker) so a slow model cannot head-of-line-block a
fast one; the metrics sink is shared so one ``stats()`` call reports the
whole server.  Every request is answered with one :class:`ServeResult`:
``ok``, ``rejected`` (queue saturated), ``deadline_exceeded``,
``unavailable`` (the model raised, or its circuit is open),
``invalid_input`` (the input guard refused it) or ``shutdown``.

Around each model sit the data-quality guards of ``quality/``: an
:class:`~..quality.drift.InputGuard` that imputes or refuses non-finite
and wildly out-of-range rows, and a :class:`~..quality.drift.DriftMonitor`
whose sustained drift trips the model's :class:`CircuitBreaker`, so a
drifting feed degrades to fallback answers.  Models hot-swap under load
(:meth:`InferenceServer.prepare_swap` / :meth:`~InferenceServer.commit_swap`),
and :meth:`~InferenceServer.health` / :meth:`~InferenceServer.metrics_text`
report the whole front door.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np

from ..device import resolve_device
from ..io.model_io import load_data_profile, load_model
from ..models.base import Model
from ..obs import trace as _trace
from ..obs.registry import MetricsRegistry, global_registry
from ..quality.drift import POLICY_REJECT, DriftMonitor, InputGuard
from ..quality.sketches import PSI_DRIFT, DataProfile
from ..tune import knob
from ..utils.faults import fault_point
from ..utils.logging import get_logger
from .batcher import Fallback, MicroBatcher
from .breaker import STATE_CLOSED, CircuitBreaker
from .bucketing import DEFAULT_BUCKETS
from .metrics import ServingMetrics
from .queue import STATUS_INVALID_INPUT, Request, ServeResult
from .registry import ModelRegistry, ServingModel

log = get_logger("serve")


@dataclass
class PreparedSwap:
    """A built-and-warmed successor plus its resolved drift profile —
    everything :meth:`InferenceServer.commit_swap` needs to flip, with
    nothing left that can fail."""

    name: str
    sm: ServingModel
    profile: DataProfile | None
    family: str


class InferenceServer:
    """Online inference over one or more registered models on ``device``
    (default the card).

    Every model is served behind its own :class:`CircuitBreaker`: repeated
    primary failures open it and requests degrade straight to the model's
    fallback instead of paying the failure each time.  ``ingest_metrics``
    (optional) folds the streaming layer's registry into :meth:`health`,
    so one snapshot covers quarantined batches and rows and source
    retries beside the breaker states.
    """

    def __init__(
        self,
        registry: ModelRegistry | None = None,
        max_queue_rows: int | None = None,
        max_wait_s: float | None = None,
        breaker_failure_threshold: int = 5,
        breaker_recovery_s: float = 5.0,
        ingest_metrics: MetricsRegistry | None = None,
        device=None,
    ):
        self.registry = registry or ModelRegistry()
        self.device = resolve_device(device)
        self.metrics: ServingMetrics = self.registry.metrics
        # None → the knob registry (serve.queue.max_rows /
        # serve.microbatch.max_wait_ms), resolved once, here
        self.max_queue_rows = (
            int(knob("serve.queue.max_rows"))
            if max_queue_rows is None else max_queue_rows
        )
        self.max_wait_s = (
            knob("serve.microbatch.max_wait_ms") / 1e3
            if max_wait_s is None else max_wait_s
        )
        self.breaker_failure_threshold = breaker_failure_threshold
        self.breaker_recovery_s = breaker_recovery_s
        self.ingest_metrics = ingest_metrics
        self._batchers: dict[str, MicroBatcher] = {}
        self._fallbacks: dict[str, Fallback] = {}
        self._breakers: dict[str, CircuitBreaker] = {}
        #: per-model input guards and drift monitors
        self._guards: dict[str, InputGuard] = {}
        self._monitors: dict[str, DriftMonitor] = {}
        #: per-model (threshold, window_rows, trip_after) from add_model,
        #: so a swap that has to CREATE a monitor keeps the tuning
        self._drift_params: dict[str, tuple[float, int, int]] = {}
        self._monitor_width_warned: set[str] = set()
        #: serializes hot swaps so the registry flip and the drift-
        #: reference rebase land as one operation
        self._swap_lock = threading.Lock()
        self._started = False
        self._register_obs()

    def _register_obs(self) -> None:
        """Fold this server into the process registry as a weakref
        pull-collector: ``serve.*`` counters, breaker states and drift PSI
        surface on the global exporters without the request path writing
        two places.  Skipped when this server's metrics already write the
        global registry (it would count twice)."""
        g = global_registry()
        if self.metrics.registry is g:
            return
        g.register_collector(
            f"serve:{id(self):x}", self, InferenceServer.obs_fragment
        )

    # ------------------------------------------------------------ obs
    #: numeric encoding of breaker states for the state gauge
    _BREAKER_CODE = {"closed": 0.0, "half_open": 1.0, "open": 2.0}

    def obs_fragment(self) -> dict:
        """This server's contribution to a registry pull: its own
        counters / gauges / histograms plus per-model breaker-state and
        drift-PSI gauges (label syntax — ``obs/export.py`` splits them)."""
        reg = self.metrics.registry
        counters = dict(reg.counters)
        gauges = dict(reg.gauges)
        for name, b in list(self._breakers.items()):
            snap = b.snapshot()
            lbl = f'{{model="{name}"}}'
            gauges[f"serve.breaker_state{lbl}"] = self._BREAKER_CODE.get(
                snap["state"], -1.0
            )
            counters[f"serve.breaker_opened{lbl}"] = float(
                snap["opened_count"]
            )
        for name, m in list(self._monitors.items()):
            s = m.snapshot()
            lbl = f'{{model="{name}"}}'
            gauges[f"serve.drift_max_psi{lbl}"] = float(s["max_psi"])
            counters[f"serve.drift_windows{lbl}"] = float(s["windows"])
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": {
                k: h.to_dict() for k, h in reg.histograms.items()
            },
        }

    def metrics_text(self) -> str:
        """Prometheus exposition text for THIS server (own registry +
        fragment) — what a ``/metrics`` endpoint would return."""
        from ..obs.export import prometheus_text

        view = MetricsRegistry()
        view.register_collector("self", self, InferenceServer.obs_fragment)
        return prometheus_text(view)

    def _breaker_for(self, name: str) -> CircuitBreaker:
        if name not in self._breakers:
            self._breakers[name] = CircuitBreaker(
                failure_threshold=self.breaker_failure_threshold,
                recovery_timeout_s=self.breaker_recovery_s,
                on_transition=self.metrics.record_breaker_transition,
            )
        return self._breakers[name]

    def _new_batcher(self, name: str, sm: ServingModel) -> MicroBatcher:
        return MicroBatcher(
            sm, max_queue_rows=self.max_queue_rows, max_wait_s=self.max_wait_s,
            fallback=self._fallbacks.get(name), metrics=self.metrics,
            breaker=self._breaker_for(name),
        ).start()

    # ------------------------------------------------------------ setup
    def add_model(
        self,
        name: str,
        model: Model | str,
        n_features: int | None = None,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        fallback: Fallback = None,
        data_profile: dict | None = None,
        input_policy: str | None = None,
        drift_threshold: float = PSI_DRIFT,
        drift_window_rows: int = 512,
        drift_trip_after: int = 3,
    ) -> ServingModel:
        """Register a fitted model (or a saved-artifact path) for serving
        on the server's device; ``fallback`` answers this model's degraded
        requests.

        ``data_profile`` is the training-time feature profile
        (``quality.DataProfile.to_dict()``; loaded from the artifact's
        metadata when ``model`` is a path).  With a profile, live traffic
        is PSI-scored against it every ``drift_window_rows`` rows, and
        ``drift_trip_after`` consecutive windows above ``drift_threshold``
        TRIP the model's circuit breaker.  ``input_policy`` guards single
        requests: ``"impute"`` repairs non-finite / wildly
        out-of-reference-range values with the reference mean and counts
        them; ``"reject"`` refuses the request (``invalid_input``)."""
        # hot-add: warmed before it is registered, then given a batcher
        if isinstance(model, str):
            if data_profile is None:
                data_profile = load_data_profile(model)
            sm = self.registry.load(
                name, model, n_features=n_features, buckets=buckets,
                warmup=self._started, device=self.device,
            )
        else:
            sm = self.registry.register(
                name, model, n_features=n_features, buckets=buckets,
                warmup=self._started, device=self.device,
            )
        self._drift_params[name] = (
            drift_threshold, drift_window_rows, drift_trip_after
        )
        if data_profile is not None:
            profile = DataProfile.from_dict(data_profile)
            self._monitors[name] = DriftMonitor(
                profile,
                threshold=drift_threshold,
                window_rows=drift_window_rows,
                trip_after=drift_trip_after,
            )
            if input_policy is not None:
                self._guards[name] = InputGuard(profile, policy=input_policy)
        elif input_policy is not None:
            # no reference: the guard catches non-finite values only
            self._guards[name] = InputGuard(None, policy=input_policy)
        self._fallbacks[name] = fallback
        if self._started:
            self._batchers[name] = self._new_batcher(name, sm)
        return sm

    def swap_model(
        self,
        name: str,
        model: Model | str,
        n_features: int | None = None,
        buckets: Sequence[int] | None = None,
        data_profile: dict | DataProfile | None = None,
    ) -> ServingModel:
        """Hot-swap the model behind ``name``: :meth:`prepare_swap` then
        :meth:`commit_swap`.

        The successor is built and warmed FIRST (no request pays for it),
        then under one lock: the drift monitor's reference is rebased to
        ``data_profile`` (the successor's training profile — scoring its
        traffic against the predecessor's would re-trip the breaker on the
        very distribution it was trained on), the registry entry and the
        live batcher's model flip, and the breaker resets.  Requests in
        flight on the old model finish on it; nothing is refused because
        of a swap."""
        return self.commit_swap(self.prepare_swap(
            name, model, n_features=n_features, buckets=buckets,
            data_profile=data_profile,
        ))

    def prepare_swap(
        self,
        name: str,
        model: Model | str,
        n_features: int | None = None,
        buckets: Sequence[int] | None = None,
        data_profile: dict | DataProfile | None = None,
    ) -> PreparedSwap:
        """Phase 1 of a hot swap: load / build / warm the successor on the
        server's device and resolve its drift profile.  Raises on any
        failure; installs nothing — the live model keeps answering."""
        if isinstance(model, str):
            if data_profile is None:
                data_profile = load_data_profile(model)
            model = load_model(model)
        if buckets is None:
            try:
                buckets = self.registry.get(name).buckets
            except KeyError:
                buckets = DEFAULT_BUCKETS
        sm = ServingModel(
            model, n_features=n_features, buckets=buckets,
            metrics=self.metrics, device=self.device,
        )
        if self._started:
            sm.warmup()
        profile = None
        if data_profile is not None:
            profile = (
                data_profile if isinstance(data_profile, DataProfile)
                else DataProfile.from_dict(data_profile)
            )
        elif name in self._monitors:
            # the successor will be PSI-scored against its predecessor's
            # training profile — say so loudly
            log.warning(
                "model swapped WITHOUT a data_profile: drift reference "
                "stays on the predecessor's training profile and may "
                "re-trip the breaker on the new model's own distribution",
                model=name,
            )
        return PreparedSwap(
            name=name, sm=sm, profile=profile, family=type(model).__name__,
        )

    def commit_swap(self, prepared: PreparedSwap) -> ServingModel:
        """Phase 2 of a hot swap: rebase the drift reference, flip the
        registry entry (``ModelRegistry.install``) and the live batcher,
        reset the breaker — all under one lock; nothing here can fail
        short of process death (the ``lifecycle.registry.swap`` fault
        site fires before anything flips)."""
        name, sm, profile = prepared.name, prepared.sm, prepared.profile
        fault_point("lifecycle.registry.swap", model=name)
        with self._swap_lock:
            if profile is not None:
                mon = self._monitors.get(name)
                if mon is not None:
                    mon.rebase(profile)
                else:
                    th, wr, ta = self._drift_params.get(
                        name, (PSI_DRIFT, 512, 3)
                    )
                    self._monitors[name] = DriftMonitor(
                        profile, threshold=th, window_rows=wr, trip_after=ta
                    )
                guard = self._guards.get(name)
                if guard is not None:
                    self._guards[name] = InputGuard(
                        profile, policy=guard.policy
                    )
            self.registry.install(name, sm)
            batcher = self._batchers.get(name)
            if batcher is not None:
                batcher.model = sm
            breaker = self._breakers.get(name)
            if breaker is not None:
                breaker.reset("model swap")
            self._monitor_width_warned.discard(name)
        log.info(
            "model hot-swapped", name=name, family=prepared.family,
            profile_rebased=profile is not None,
        )
        return sm

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "InferenceServer":
        """Warm every bucket, then start the batcher workers — in that
        order, so no request races a warmup."""
        for name in self.registry.names():
            sm = self.registry.get(name)
            sm.warmup()
            if name not in self._batchers:
                self._batchers[name] = self._new_batcher(name, sm)
        self._started = True
        log.info("inference server started", models=len(self._batchers))
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

    # ------------------------------------------------------------ serve
    def _batcher(self, name: str) -> MicroBatcher:
        if name not in self._batchers:
            raise KeyError(
                f"model {name!r} is not being served "
                f"(started={self._started}); have {sorted(self._batchers)}"
            )
        return self._batchers[name]

    def _guard_input(
        self, name: str, x: np.ndarray
    ) -> tuple[np.ndarray, Request | None]:
        """Input guard + drift observation for one request.  Returns the
        (possibly repaired) rows, or a pre-answered ``invalid_input``
        request when the reject policy refused them."""
        guard = self._guards.get(name)
        if guard is not None:
            fixed, n_bad, reasons = guard.inspect(x)
            if n_bad:
                if guard.policy == POLICY_REJECT:
                    self.metrics.record_input_rejected()
                    req = Request(
                        x=np.atleast_2d(np.asarray(x, dtype=np.float64)),
                        enqueued_at=time.monotonic(), deadline=None,
                    )
                    req.complete(ServeResult(
                        None, STATUS_INVALID_INPUT,
                        detail="; ".join(reasons),
                    ))
                    self.metrics.record_request(0.0, STATUS_INVALID_INPUT)
                    return x, req
                self.metrics.record_inputs_imputed(n_bad)
                x = fixed
        monitor = self._monitors.get(name)
        if monitor is not None:
            rows = np.atleast_2d(np.asarray(x, dtype=np.float64))
            if rows.shape[1] != len(monitor.reference.names):
                # an armed monitor that can never observe is worse than
                # none — say so once instead of silently never tripping
                if name not in self._monitor_width_warned:
                    self._monitor_width_warned.add(name)
                    log.warning(
                        "drift monitor inert: request width != profile",
                        model=name, request_width=int(rows.shape[1]),
                        profile_width=len(monitor.reference.names),
                    )
            else:
                monitor.observe(rows)
                if monitor.should_trip():
                    self.metrics.record_drift_trip()
                    self._breaker_for(name).trip(
                        f"sustained input drift (max PSI "
                        f"{monitor.max_psi:.3f} > {monitor.threshold})"
                    )
                    log.error(
                        "drift trip: serving degraded",
                        model=name, max_psi=round(monitor.max_psi, 4),
                    )
        return x, None

    def submit(self, name: str, x: np.ndarray,
               deadline_s: float | None = None) -> Request:
        """Admit a request; ``.wait()`` on the returned Request yields the
        :class:`ServeResult`."""
        batcher = self._batcher(name)  # unknown-model KeyError first
        x, refused = self._guard_input(name, x)
        if refused is not None:
            return refused
        return batcher.submit(x, deadline_s=deadline_s)

    def predict(self, name: str, x: np.ndarray, deadline_s: float | None = None,
                wait_timeout_s: float | None = 30.0) -> ServeResult:
        # the serve.request span brackets admission → answer on the
        # caller's thread, so its duration is the latency the client saw;
        # span() is a shared no-op when tracing is off
        sp = _trace.span("serve.request")
        with sp:
            result = self._predict_traced(sp, name, x, deadline_s,
                                          wait_timeout_s)
        return result

    def _predict_traced(
        self, sp, name: str, x: np.ndarray, deadline_s: float | None,
        wait_timeout_s: float | None,
    ) -> ServeResult:
        req = self.submit(name, x, deadline_s=deadline_s)
        result = req.wait(wait_timeout_s)
        if sp.trace_id is not None:
            sp.note("model", name)
            sp.note("status", result.status)
            sp.note("rows", int(req.x.shape[0]))
        return result

    # ------------------------------------------------------------ observe
    def stats(self) -> dict[str, Any]:
        out = self.metrics.snapshot()
        # snapshot before iterating: a concurrent add_model / swap / stop
        # mutates these dicts
        out["models"] = {
            name: {
                "buckets": list(b.model.buckets),
                "n_features": b.model.n_features,
                "queue_depth_rows": b.queue.depth_rows,
                "jit_cache_size": b.model.jit_cache_size(),
                "breaker": self._breakers[name].state
                if name in self._breakers else None,
            }
            for name, b in list(self._batchers.items())
        }
        return out

    def health(self) -> dict[str, Any]:
        """Liveness / degradation snapshot: breaker state per model plus
        the self-healing counters (quarantined batches and rows, retry
        totals) — what a ``/healthz`` endpoint would poll.  ``lifecycle``
        is None: no lifecycle controller attaches to the port's server
        yet."""
        breakers = {
            name: b.snapshot() for name, b in list(self._breakers.items())
        }
        drift = {
            name: m.snapshot() for name, m in list(self._monitors.items())
        }
        # status derives from breaker state only: SUSTAINED drift reaches
        # it through trip(); a single hot window shows in "drifting" only
        degraded = any(
            b["state"] != STATE_CLOSED for b in breakers.values()
        )
        serve_c = self.metrics.registry.counters
        ingest_c = (
            self.ingest_metrics.counters if self.ingest_metrics is not None
            else serve_c  # a shared registry folds ingest counters in
        )
        return {
            "status": (
                "stopped" if not self._started
                else "degraded" if degraded else "ok"
            ),
            "started": self._started,
            "lifecycle": None,
            "models_serving": sorted(self._batchers),
            "breakers": breakers,
            "drift": drift,
            "quarantined_batches": int(ingest_c.get("stream.quarantined", 0)),
            "quarantined_rows": int(ingest_c.get("stream.rows_rejected", 0)),
            "drift_events": int(ingest_c.get("stream.drift_events", 0)),
            "retry_totals": {
                "source_reads": int(ingest_c.get("stream.retries", 0)),
                "batch_replays": int(ingest_c.get("stream.batch_failures", 0)),
                "primary_failures": int(serve_c.get("serve.primary_failures", 0)),
            },
            "fallback_answers": int(serve_c.get("serve.fallback_answers", 0)),
            "inputs_imputed": int(serve_c.get("serve.inputs_imputed", 0)),
            "inputs_rejected": int(serve_c.get("serve.inputs_rejected", 0)),
            "drift_trips": int(serve_c.get("serve.drift_trips", 0)),
        }

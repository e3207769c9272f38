"""ReplicaSet: N model replicas behind one tenant-aware front door.

The fabric that multiplies the single :class:`~..server.InferenceServer`
into a fleet: placement assigns each replica an explicit device slice
(:mod:`.placement`), every replica runs its own full server — registry,
pre-warmed buckets, micro-batchers, breakers, drift guards — and three
fleet-level pieces sit in front:

* the :class:`~.router.Router` (least-loaded or consistent-hash-per-
  tenant; a hospital's traffic sticks to one warm replica slice and
  fails over clockwise when it dies);
* the :class:`~.admission.AdmissionController` (per-tenant token-bucket
  quotas + SLO classes with ordered shed thresholds — the rungs ABOVE
  the per-replica shed/deadline ladder);
* atomic fleet-wide promotion: :meth:`swap_model` prepares EVERY
  replica's successor model first (anything that can fail), then
  commits pure in-memory flips — a lifecycle canary/PROMOTED transition
  flips every replica or none.  The surface matches what
  ``lifecycle/controller.py`` calls on a single server (``add_model`` /
  ``swap_model`` / ``registry.names()`` / ``attach_lifecycle`` /
  ``device``), so a controller drives a fleet unchanged.

On one card every replica serves from that card (``EvenPlacement``'s
oversubscription): each replica's batches are its own K2 launches on the
shared device.

Fleet-level observability goes through the obs registry's PULL-COLLECTOR
path: each replica registers a collector on the fleet's
``MetricsRegistry``; :meth:`health` is a read of ``collect()`` — replica
counters SUM into fleet totals, per-replica gauges stay labeled by
``obs.registry.replica_label`` — never a second ad-hoc dict walk.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Sequence

import numpy as np
import torch

from ...device import resolve_device
from ...io.model_io import load_data_profile, load_model
from ...obs import trace as _trace
from ...obs.registry import (
    MetricsRegistry,
    LATENCY_EDGES_S,
    replica_label,
    split_labels,
)
from ...tune import knob
from ...utils.faults import fault_point
from ...utils.logging import get_logger
from ..breaker import STATE_OPEN
from ..bucketing import DEFAULT_BUCKETS
from ..queue import (
    Request,
    ServeResult,
    STATUS_REJECTED,
    STATUS_UNAVAILABLE,
)
from ..server import InferenceServer
from .admission import AdmissionController, SLO_INTERACTIVE, SLO_SHED_ORDER
from .placement import EvenPlacement, Placement, ReplicaSlice
from .router import NoReplicaAvailable, POLICY_CONSISTENT_HASH, Router

log = get_logger("serve")

#: replica lifecycle states
REPLICA_LIVE = "live"
REPLICA_DRAINING = "draining"
REPLICA_DEAD = "dead"

_STATE_CODE = {REPLICA_LIVE: 0.0, REPLICA_DRAINING: 1.0, REPLICA_DEAD: 2.0}
_BREAKER_CODE = {"closed": 0.0, "half_open": 1.0, "open": 2.0}
_BREAKER_NAME = {v: k for k, v in _BREAKER_CODE.items()}

#: sentinel: build the default AdmissionController (SLO ladder, no quotas)
DEFAULT_ADMISSION = "default"


def default_devices() -> list:
    """Every card, ``cuda:0`` … ``cuda:N-1``; raises without one (the CPU
    serves only when the caller names it)."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Replica:
    """One replica: its placement slice, its server, its health state.

    Satisfies the router's :class:`~.router.RoutableReplica` protocol and
    contributes the fleet registry's per-replica collector fragment."""

    def __init__(self, index: int, slice_: ReplicaSlice, server: InferenceServer):
        self.index = index
        self.slice = slice_
        self.server = server
        self.state = REPLICA_LIVE

    # ------------------------------------------------------------ routing
    def healthy(self) -> bool:
        return self.state == REPLICA_LIVE

    def load_rows(self) -> int:
        # snapshot before iterating: kill_replica's server.stop() clears
        # the batcher dict concurrently, and a front-door read must never
        # raise "dict changed size" at a client
        return sum(
            b.queue.depth_rows for b in list(self.server._batchers.values())
        )

    def capacity_rows(self) -> int:
        batchers = list(self.server._batchers.values())
        if not batchers:
            return self.server.max_queue_rows
        return sum(b.queue.max_rows for b in batchers)

    def breaker_open(self, model: str) -> bool:
        b = self.server._breakers.get(model)
        return b is not None and b.state == STATE_OPEN

    # ------------------------------------------------------------ obs
    def obs_fragment(self) -> dict:
        """This replica's contribution to the fleet registry pull:
        the server's own counters/histograms (counters SUM into fleet
        totals at collect) plus per-replica labeled gauges — every
        ``replica=`` label minted by ``obs.registry.replica_label``
        (the bounded form ``tools/check_obs.py`` enforces)."""
        reg = self.server.metrics.registry
        counters = dict(reg.counters)
        gauges = {
            f'fleet.replica_state{{replica="{replica_label(self.index)}"}}':
                _STATE_CODE[self.state],
            f'fleet.replica_queue_rows{{replica="{replica_label(self.index)}"}}':
                float(self.load_rows()),
        }
        for model, b in list(self.server._breakers.items()):
            snap = b.snapshot()
            gauges[
                f'fleet.breaker_state{{model="{model}",'
                f'replica="{replica_label(self.index)}"}}'
            ] = _BREAKER_CODE.get(snap["state"], -1.0)
        histograms = {}
        # list(): record_request creates histograms on first use — a
        # concurrent pull must not lose the fragment to a resize race
        for hname, h in list(reg.histograms.items()):
            histograms[
                f'{hname}{{replica="{replica_label(self.index)}"}}'
            ] = h.to_dict()
        return {
            "counters": counters, "gauges": gauges, "histograms": histograms,
        }


class _FleetModelView:
    """Model-registry facade over the fleet (``names()``/``get()``) —
    the surface ``lifecycle/controller.py`` reads off a single server's
    ``.registry``, answered fleet-wide."""

    def __init__(self, fleet: "ReplicaSet"):
        self._fleet = fleet

    def names(self) -> list[str]:
        return sorted(self._fleet._model_names)

    def get(self, name: str):
        for r in self._fleet._replicas:
            if r.state != REPLICA_DEAD:
                return r.server.registry.get(name)
        raise KeyError(f"no live replica serving {name!r}")


class ReplicaSet:
    """N replicas + router + admission: the fleet front door.

    ``admission=DEFAULT_ADMISSION`` ships the standard SLO ladder with no
    tenant quotas; pass a configured :class:`AdmissionController` for
    quotas, or ``None`` to serve with the bare per-replica ladder only
    (the pre-fleet behavior, per replica).

    ``devices=None`` is every card (``cuda:0`` … ``cuda:N-1``) and raises
    without one; the CPU serves only when the caller names it, e.g.
    ``devices=("cpu",) * n``.
    """

    def __init__(
        self,
        n_replicas: int = 2,
        devices: Sequence[Any] | None = None,
        placement: Placement | None = None,
        policy: str = POLICY_CONSISTENT_HASH,
        vnodes: int = 160,
        admission: AdmissionController | str | None = DEFAULT_ADMISSION,
        max_queue_rows: int | None = None,
        max_wait_s: float | None = None,
        breaker_failure_threshold: int = 5,
        breaker_recovery_s: float = 5.0,
    ):
        if devices is None:
            devices = default_devices()
        self.placement = placement or EvenPlacement()
        self.slices = self.placement.assign(n_replicas, devices)
        #: the first replica's primary — where a lifecycle controller
        #: over this fleet builds its candidate's shadow ServingModel
        self.device = resolve_device(self.slices[0].primary)
        #: per-replica server recipe, kept so revive_replica can rebuild
        #: a dead replica's server bit-for-bit on its original slice.
        #: Knob-owned bounds resolve ONCE here — every replica (and
        #: every revive) shares the value selected at fleet build time;
        #: live retuning (``set_max_wait_s``) moves the running batchers
        #: AND this recipe, so revives serve the retuned value.
        self._server_kw = dict(
            max_queue_rows=(
                int(knob("serve.queue.max_rows"))
                if max_queue_rows is None else max_queue_rows
            ),
            max_wait_s=(
                knob("serve.microbatch.max_wait_ms") / 1e3
                if max_wait_s is None else max_wait_s
            ),
            breaker_failure_threshold=breaker_failure_threshold,
            breaker_recovery_s=breaker_recovery_s,
        )
        self._replicas = self._make_replicas(self.slices)
        self.router = Router(self._replicas, policy=policy, vnodes=vnodes)
        self.admission: AdmissionController | None = (
            AdmissionController() if admission == DEFAULT_ADMISSION
            else admission
        )
        #: fleet-level metrics; each replica is a pull-collector, so one
        #: collect() merges the whole fleet (the health() substrate)
        self.metrics = MetricsRegistry()
        for r in self._replicas:
            self.metrics.register_collector(
                f"replica:{r.index}", r, Replica.obs_fragment
            )
        self.registry = _FleetModelView(self)
        self._model_names: set[str] = set()
        self._fallbacks: dict[str, Any] = {}
        #: name → the add/swap arguments a revived replica re-registers
        self._model_specs: dict[str, dict] = {}
        self._lifecycle = None
        self._swap_lock = threading.Lock()
        self._started = False
        #: front-door fast lane: the per-SLO metric label keys are
        #: interned once instead of f-string-built per request
        self._slo_keys: dict[str, tuple[str, str]] = {
            slo: (
                f'fleet.requests_slo{{slo="{slo}"}}',
                f'fleet.shed{{slo="{slo}"}}',
            )
            for slo in SLO_SHED_ORDER
        }
        log.info(
            "replica set built", replicas=n_replicas,
            policy=policy, devices=len(tuple(devices)),
        )

    # ------------------------------------------------------------ seams
    def _build_server(self, slice_: ReplicaSlice):
        """Build one replica's server on its slice — the seam the
        multi-process fleet (:mod:`.proc`) overrides to spawn a real OS
        process instead of an in-process :class:`InferenceServer`.
        Used by both construction and :meth:`revive_replica`, so a
        revived replica is rebuilt through the same path it was born."""
        return InferenceServer(device=slice_.primary, **self._server_kw)

    def _make_replicas(self, slices) -> list[Replica]:
        """Every replica, in slice order (the multi-process fleet spawns
        its workers side by side)."""
        return [self._make_replica(s) for s in slices]

    def _make_replica(self, slice_: ReplicaSlice) -> Replica:
        """Wrap a slice and its freshly built server in the fleet's
        replica type (the proc fleet returns a :class:`ProcReplica`
        whose health/load reads are parent-side)."""
        return Replica(slice_.replica_id, slice_, self._build_server(slice_))

    # ------------------------------------------------------------ setup
    def add_model(
        self,
        name: str,
        model,
        n_features: int | None = None,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        fallback=None,
        data_profile: dict | None = None,
        **guard_kw,
    ) -> None:
        """Register a model on EVERY replica (loaded from disk once when
        ``model`` is a path); each replica builds its own serving model
        on its own device slice.  ``guard_kw`` passes the drift/guard
        tuning through (``input_policy``, ``drift_threshold``, ...)."""
        if isinstance(model, str):
            if data_profile is None:
                data_profile = load_data_profile(model)
            model = load_model(model)
        for r in self._replicas:
            if r.state == REPLICA_DEAD:
                continue
            r.server.add_model(
                name, model, n_features=n_features, buckets=buckets,
                fallback=fallback, data_profile=data_profile, **guard_kw,
            )
        self._model_names.add(name)
        self._fallbacks[name] = fallback
        self._model_specs[name] = dict(
            model=model, n_features=n_features, buckets=buckets,
            fallback=fallback, data_profile=data_profile,
            guard_kw=dict(guard_kw),
        )

    def swap_model(
        self,
        name: str,
        model,
        n_features: int | None = None,
        buckets: Sequence[int] | None = None,
        data_profile: dict | None = None,
    ) -> list:
        """Atomic fleet-wide hot swap — the promotion primitive a
        lifecycle PROMOTED transition drives.

        Phase 1 PREPARES a successor per replica (artifact load, build,
        per-device warmup — everything that can fail); phase 2 COMMITS
        pure in-memory flips under the fleet lock.  Any phase-1 failure
        raises with ZERO replicas flipped; once phase 2 starts nothing
        can fail short of process death — every replica or none."""
        with _trace.span("fleet.promote", {"model": name}) as sp:
            if isinstance(model, str):
                if data_profile is None:
                    data_profile = load_data_profile(model)
                model = load_model(model)
            with self._swap_lock:
                targets = [
                    r for r in self._replicas if r.state != REPLICA_DEAD
                ]
                prepared = []
                for r in targets:
                    fault_point(
                        "fleet.swap.prepare", replica=r.index, model=name
                    )
                    prepared.append((r, r.server.prepare_swap(
                        name, model, n_features=n_features,
                        buckets=buckets, data_profile=data_profile,
                    )))
                fault_point("fleet.swap.commit", model=name)
                # fire_fault_point=False: the per-replica swap site must
                # not be injectable mid-way through an all-or-none commit
                swapped = [
                    r.server.commit_swap(p, fire_fault_point=False)
                    for r, p in prepared
                ]
            self.metrics.inc("fleet.promotions")
            if sp.trace_id is not None:
                sp.note("replicas", len(swapped))
        self._model_names.add(name)
        prev = self._model_specs.get(name, {})
        self._model_specs[name] = dict(
            model=model, n_features=n_features,
            buckets=buckets if buckets is not None else prev.get("buckets"),
            fallback=prev.get("fallback"), data_profile=data_profile,
            guard_kw=prev.get("guard_kw", {}),
        )
        log.info(
            "fleet-wide hot swap", model=name, replicas=len(swapped),
        )
        return swapped

    def attach_lifecycle(self, controller) -> None:
        """Wire one lifecycle controller into every replica's request
        path (canary routing, shadow/drift observation) — the controller
        aggregates across replicas through its own locks."""
        self._lifecycle = controller
        for r in self._replicas:
            r.server.attach_lifecycle(controller)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ReplicaSet":
        for r in self._replicas:
            if r.state != REPLICA_DEAD:
                r.server.start()
        self._started = True
        log.info(
            "fleet started",
            replicas=sum(1 for r in self._replicas if r.healthy()),
            models=len(self._model_names),
        )
        return self

    def stop(self) -> None:
        for r in self._replicas:
            r.server.stop()
        self._started = False

    def __enter__(self) -> "ReplicaSet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ replicas
    @property
    def replicas(self) -> tuple[Replica, ...]:
        return tuple(self._replicas)

    def kill_replica(self, index: int) -> None:
        """Abrupt replica death (chaos surface): the router stops picking
        it FIRST, then its server stops — queued requests are answered
        ``shutdown`` (cleanly shed, never stranded) and consistent-hash
        tenants fail over to their ring successor."""
        r = self._replicas[index]
        r.state = REPLICA_DEAD
        r.server.stop()
        self.metrics.inc("fleet.replicas_killed")
        log.warning("replica killed", replica=index)

    def revive_replica(self, index: int) -> None:
        """Bring a dead replica back: rebuild its server from the stored
        recipe on its ORIGINAL device slice, re-register every served
        model from the fleet's model specs (so it serves exactly what its
        live peers serve, including post-kill hot swaps), and rejoin the
        ring.  Consistent-hash tenants that failed over clockwise come
        home on their next request — the recovery half of the chaos
        surface :meth:`kill_replica` opens."""
        r = self._replicas[index]
        if r.state != REPLICA_DEAD:
            raise ValueError(
                f"replica {index} is {r.state!r}, not dead — revive is "
                "only defined for killed/drained replicas"
            )
        server = self._build_server(r.slice)
        for name, spec in list(self._model_specs.items()):
            server.add_model(
                name, spec["model"], n_features=spec["n_features"],
                buckets=spec["buckets"] or DEFAULT_BUCKETS,
                fallback=spec["fallback"],
                data_profile=spec["data_profile"], **spec["guard_kw"],
            )
        if self._lifecycle is not None:
            server.attach_lifecycle(self._lifecycle)
        if self._started:
            server.start()
        # old server already stopped by kill/drain; swap in place — the
        # Replica object (and its registered collector) stays the same
        r.server = server
        r.state = REPLICA_LIVE
        self.metrics.inc("fleet.replicas_revived")
        log.info("replica revived", replica=index)

    def drain_replica(self, index: int, timeout_s: float = 5.0) -> bool:
        """Graceful removal, phase 1: stop routing new work to the
        replica, wait for its queues to empty, then stop it.  Returns
        True when the drain completed inside ``timeout_s``."""
        r = self._replicas[index]
        r.state = REPLICA_DRAINING
        deadline = time.monotonic() + timeout_s
        drained = False
        while time.monotonic() < deadline:
            if r.load_rows() == 0:
                drained = True
                break
            time.sleep(0.005)
        r.server.stop()  # in-flight batch finishes; leftovers answer shutdown
        r.state = REPLICA_DEAD
        self.metrics.inc("fleet.replicas_drained")
        return drained

    def remove_replica(self, index: int, timeout_s: float = 5.0) -> bool:
        """Scale-down: drain, then take the replica off the hash ring —
        its tenants reshuffle to ring successors (~1/N of the space,
        the consistent-hash contract)."""
        drained = self.drain_replica(index, timeout_s=timeout_s)
        self.router.remove_replica(index)
        return drained

    def load_factor(self) -> float:
        """Queued rows / queue capacity across live replicas — the
        fleet-wide load gauge ``health()`` reports.  (Admission
        thresholds against the ROUTED replica's queue, not this
        average — see ``_front_door``.)"""
        live = [r for r in self._replicas if r.healthy()]
        if not live:
            return 1.0
        cap = sum(r.capacity_rows() for r in live)
        if cap <= 0:
            return 1.0
        return min(sum(r.load_rows() for r in live) / cap, 1.0)

    # ------------------------------------------------------------ serving
    def _shed(self, x2: np.ndarray, status: str, detail: str) -> Request:
        req = Request(x=x2, enqueued_at=time.monotonic(), deadline=None)
        req.complete(ServeResult(None, status, detail=detail))
        return req

    def _front_door(
        self,
        name: str,
        x2: np.ndarray,
        tenant_id: str | None,
        slo: str,
        deadline_s: float | None,
    ) -> tuple[Replica | None, float | None, Request | None]:
        """Routing + admission for one request: returns (replica,
        effective deadline, pre-answered shed request or None).

        Routing runs FIRST and admission thresholds against the ROUTED
        replica's queue load, not a fleet average: the class ladder then
        acts as reserved headroom per queue — with the shipped ladder,
        batch stops contending at 45% of the replica's queue and
        best_effort at 25% — so the top slice of every queue is
        effectively reserved for interactive and a lower class can
        never fill the queue an interactive request is about to need.
        (Fleet-averaged load lets class-blind per-replica queue
        rejections starve interactive anyway — measured, not
        hypothetical.)"""
        if name not in self._model_names:
            # loud, like the single server's KeyError: an unknown model
            # is a caller bug, not a replica loss to reroute around
            raise KeyError(
                f"model {name!r} is not served by this fleet; "
                f"have {sorted(self._model_names)}"
            )
        m = self.metrics
        keys = self._slo_keys.get(slo)
        if keys is None:
            # unknown class: reject BEFORE counting or interning — slo
            # is a metric label and an intern key, and caller-supplied
            # garbage must not grow either without bound
            known = (
                self.admission.classes if self.admission is not None
                else ()
            )
            if slo not in known:
                raise ValueError(
                    f"unknown SLO class {slo!r}; one of "
                    f"{sorted(known) or list(SLO_SHED_ORDER)}"
                )
            keys = (  # a configured custom class: intern its keys once
                f'fleet.requests_slo{{slo="{slo}"}}',
                f'fleet.shed{{slo="{slo}"}}',
            )
            self._slo_keys[slo] = keys
        m.inc("fleet.requests")
        m.inc(keys[0])
        with _trace.span("router.route") as sp:
            try:
                replica = self.router.route(tenant_id=tenant_id, model=name)
            except NoReplicaAvailable as e:
                m.inc("fleet.no_replica")
                return None, deadline_s, self._shed(
                    x2, STATUS_UNAVAILABLE, str(e)
                )
            if sp.trace_id is not None:
                sp.note("policy", self.router.policy)
                sp.note("replica", replica_label(replica.index))
        if self.admission is not None:
            cap = replica.capacity_rows()
            load = replica.load_rows() / cap if cap > 0 else 1.0
            decision = self.admission.admit(
                tenant_id, slo, int(x2.shape[0]), load
            )
            if deadline_s is None:
                deadline_s = decision.deadline_s
            if not decision.admitted:
                m.inc(keys[1])
                m.inc(
                    "fleet.shed_quota"
                    if decision.reason.startswith("quota:")
                    else "fleet.shed_load"
                )
                return None, deadline_s, self._shed(
                    x2, STATUS_REJECTED, f"admission: {decision.reason}"
                )
        return replica, deadline_s, None

    def _reroute(self, name: str, tenant_id: str | None) -> Replica | None:
        """A replica vanished between routing and dispatch (killed
        mid-flight): pick again — the router already excludes it."""
        self.metrics.inc("fleet.rerouted")
        try:
            return self.router.route(tenant_id=tenant_id, model=name)
        except NoReplicaAvailable:
            self.metrics.inc("fleet.no_replica")
            return None

    def submit(
        self,
        name: str,
        x: np.ndarray,
        tenant_id: str | None = None,
        slo: str = SLO_INTERACTIVE,
        deadline_s: float | None = None,
    ) -> Request:
        """Admit + route + enqueue, never blocks: the open-loop entry the
        load generator drives.  Every path returns a Request that WILL be
        answered — admission sheds and dead-fleet refusals come back
        pre-answered."""
        x2 = np.asarray(x)
        if x2.ndim == 1:
            x2 = x2[None, :]
        replica, deadline_s, shed = self._front_door(
            name, x2, tenant_id, slo, deadline_s
        )
        if shed is not None:
            return shed
        # retry while a healthy replica exists: each KeyError is a replica
        # dying between routing and dispatch, and the router already
        # excludes the dead — bounded by the replica count, and a live
        # replica is never discarded mid-retry
        for _ in range(len(self._replicas) + 1):
            if replica is None:
                break
            try:
                return replica.server.submit(name, x2, deadline_s=deadline_s)
            except KeyError:
                replica = self._reroute(name, tenant_id)
        return self._shed(x2, STATUS_UNAVAILABLE, "replica lost mid-dispatch")

    def _predict_routed(
        self,
        name: str,
        x: np.ndarray,
        route_key: str | None,
        slo: str,
        deadline_s: float | None,
        dispatch,
    ) -> ServeResult:
        """The ONE synchronous dispatch core both front doors share:
        fleet.request span → admission+route (``route_key`` drives the
        sticky hash) → ``dispatch(replica, x2, deadline_s)`` with one
        reroute on replica loss → per-class latency accounting over OK
        answers ONLY (folding ~0-latency sheds into the histogram would
        make p99 read healthiest exactly during overload)."""
        sp = _trace.span("fleet.request")
        with sp:
            x2 = np.asarray(x)
            if x2.ndim == 1:
                x2 = x2[None, :]
            replica, deadline_s, shed = self._front_door(
                name, x2, route_key, slo, deadline_s
            )
            if shed is not None:
                result = shed.wait(0.0)
            else:
                # same bounded retry as submit(): never discard a live
                # replica the reroute just found
                result = None
                for _ in range(len(self._replicas) + 1):
                    if replica is None:
                        break
                    try:
                        result = dispatch(replica, x2, deadline_s)
                        break
                    except KeyError:
                        replica = self._reroute(name, route_key)
                if result is None:
                    result = ServeResult(
                        None, STATUS_UNAVAILABLE,
                        detail="replica lost mid-dispatch",
                    )
            if result.ok:
                self.metrics.observe(
                    f'fleet.latency_seconds{{slo="{slo}"}}',
                    result.latency_s, LATENCY_EDGES_S,
                )
            if sp.trace_id is not None:
                sp.note("model", name)
                sp.note("slo", slo)
                sp.note("status", result.status)
                if replica is not None:
                    sp.note("replica", replica_label(replica.index))
        return result

    def set_max_wait_s(self, max_wait_s: float) -> int:
        """Retune the micro-batch linger fleet-wide, live: one float
        attribute store per running batcher (each worker reads
        ``max_wait_s`` fresh every loop — the existing atomic path, no
        new mutation protocol) plus the revive recipe, so a replica
        revived after the retune serves the tuned value too.  This is
        the apply seam of :class:`~...tune.live.LiveRetuner`; returns
        the number of batchers moved."""
        wait = float(max_wait_s)
        self._server_kw["max_wait_s"] = wait
        moved = 0
        for r in self._replicas:
            if r.state == REPLICA_DEAD:
                continue
            for b in list(r.server._batchers.values()):
                b.max_wait_s = wait
                moved += 1
        return moved

    def predict(
        self,
        name: str,
        x: np.ndarray,
        tenant_id: str | None = None,
        slo: str = SLO_INTERACTIVE,
        deadline_s: float | None = None,
        wait_timeout_s: float | None = 30.0,
    ) -> ServeResult:
        """Synchronous front door: admission → route → the replica's own
        ``predict`` (guards, lifecycle hooks, serve.request span) → per-
        class latency accounting.  The ``fleet.request`` span roots the
        route: one trace id covers router→replica→model→answer."""
        return self._predict_routed(
            name, x, tenant_id, slo, deadline_s,
            lambda r, x2, dl: r.server.predict(
                name, x2, deadline_s=dl, wait_timeout_s=wait_timeout_s
            ),
        )

    def predict_tenant(
        self,
        name: str,
        tenant_id,
        x: np.ndarray,
        slo: str = SLO_INTERACTIVE,
        deadline_s: float | None = None,
        wait_timeout_s: float | None = 30.0,
    ) -> ServeResult:
        """Tenant-routed predict over a served model farm: the SAME
        normalized tenant key drives the consistent-hash replica choice
        (sticky slice) and the farm's in-band slice gather on that
        replica.  Not-routable models answer ``invalid_input`` through
        the replica's own 400 lane."""
        model_view = None
        try:
            model_view = self.registry.get(name).model
        except KeyError:
            pass
        affinity = getattr(model_view, "affinity_key", str)(tenant_id)
        return self._predict_routed(
            name, x, affinity, slo, deadline_s,
            lambda r, x2, dl: r.server.predict_tenant(
                name, tenant_id, x2, deadline_s=dl,
                wait_timeout_s=wait_timeout_s,
            ),
        )

    # ------------------------------------------------------------ observe
    def health(self) -> dict[str, Any]:
        """Fleet health, read off ONE ``metrics.collect()`` — the pull-
        collector merge (replica counters sum, per-replica gauges keep
        their ``replica=`` labels) — instead of a second ad-hoc walk
        over replica dicts.  The key set is pinned by
        ``tests/test_torch_fleet.py``, equal to the JAX package's."""
        snap = self.metrics.collect()
        c, g = snap["counters"], snap["gauges"]
        per_breaker: dict[str, dict[str, str]] = {}
        for key, val in g.items():
            base, labels = split_labels(key)
            if base == "fleet.breaker_state" and "replica" in labels:
                per_breaker.setdefault(labels["replica"], {})[
                    labels["model"]
                ] = _BREAKER_NAME.get(val, "unknown")
        replicas: dict[str, dict] = {}
        for r in self._replicas:
            lbl = replica_label(r.index)
            replicas[lbl] = {
                "state": r.state,
                "queue_rows": int(g.get(
                    f'fleet.replica_queue_rows{{replica="{replica_label(r.index)}"}}',
                    0,
                )),
                "breakers": per_breaker.get(lbl, {}),
            }
        breaker_degraded = any(
            state != "closed"
            for rep in replicas.values()
            for state in rep["breakers"].values()
        )
        degraded = breaker_degraded or any(
            r.state != REPLICA_LIVE for r in self._replicas
        )
        return {
            "status": (
                "stopped" if not self._started
                else "degraded" if degraded else "ok"
            ),
            "started": self._started,
            "replicas": replicas,
            "models_serving": sorted(self._model_names),
            "requests": int(c.get("fleet.requests", 0)),
            "served_requests": int(c.get("serve.requests", 0)),
            "shed": {
                slo: int(c.get(f'fleet.shed{{slo="{slo}"}}', 0))
                for slo in SLO_SHED_ORDER
            },
            "shed_quota": int(c.get("fleet.shed_quota", 0)),
            "shed_load": int(c.get("fleet.shed_load", 0)),
            "no_replica": int(c.get("fleet.no_replica", 0)),
            "rerouted": int(c.get("fleet.rerouted", 0)),
            "promotions": int(c.get("fleet.promotions", 0)),
            "replicas_killed": int(c.get("fleet.replicas_killed", 0)),
            "replicas_revived": int(c.get("fleet.replicas_revived", 0)),
            "fallback_answers": int(c.get("serve.fallback_answers", 0)),
            "drift_trips": int(c.get("serve.drift_trips", 0)),
            "queue_rows_total": sum(
                rep["queue_rows"] for rep in replicas.values()
            ),
            "load_factor": round(self.load_factor(), 4),
        }

    def stats(self) -> dict[str, Any]:
        """Raw merged snapshot (counters/gauges/histograms) — the full
        collect(), for dashboards; ``health()`` is the curated view."""
        return self.metrics.collect()

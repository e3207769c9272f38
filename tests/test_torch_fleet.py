"""The port's serving fleet (``serve/fleet/``) against the JAX package's, on
the CPU.

The host pieces — placement, the hash ring, the router, the token bucket
and the SLO ladder, the load generator and its class report — are copies
of the reference's host code, so they are held ``==`` to it on the same
inputs.  The in-process fleet runs four replicas on ``devices=("cpu",) *
4`` and follows the contracts ``tests/test_fleet.py`` pins for the
reference fleet.  The frame transport and the watchdog's flight dump are
read across the packages, the served models pickle without their device
caches, and a lifecycle controller promotes over a two-replica fleet, as
the JAX package's controller does over its own.

Tolerances, each with its reason:

* ``CENTER_TOL`` = 3e-5: the lifecycle's promoted centers against the
  JAX package's, the retrain's float32 Lloyd sums run in another order
  over the same rows (``tests/test_torch_lifecycle.py``'s bound).

Everything else is ``==``: the fleet's answers are KMeans assignments of
tie-free rows (each row's nearest center is nearer than the second by
more than 1e-3, where the port's and the reference's float32 distances
differ by ulps), the lifecycle's journals are host decisions, and its
port runs compared with each other run the same port code.
"""

from __future__ import annotations

import os
import pickle
import socket
import threading
import time

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port
from clustermachinelearningforhospitalnetworks_apache_spark_tpu import lifecycle as JL
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.obs.flight_recorder import (
    read_dump as jax_read_dump,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.parallel.partitioner import (
    partition_devices as jax_partition_devices,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.serve import fleet as JF
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.serve.fleet import proc as JFP
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.utils import faults as jfaults
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import lifecycle as PL
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.obs import trace
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.serve import (
    STATUS_INVALID_INPUT,
    STATUS_REJECTED,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.serve import fleet as F
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.serve.fleet import proc as FP
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.serve.fleet.placement import (
    partition_devices,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import faults

# the suite runs several worker processes on a few cores: one intra-op
# thread per worker keeps torch from oversubscribing them
torch.set_num_threads(1)

D = 4
K = 6
BUCKETS = (1, 8)
CPU4 = ("cpu",) * 4


# ------------------------------------------------------------------ fixtures
@pytest.fixture(scope="module")
def km():
    """A JAX KMeans(k=6) on 4-d blobs carried to the port with
    ``convert.py``, and tie-free probe rows: (JAX model, port model,
    rows)."""
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=4.0, size=(K, D))
    x = (centers[rng.integers(0, K, 600)] + rng.normal(size=(600, D))).astype(np.float32)
    jm = J.models.kmeans.KMeans(k=K, seed=0, max_iter=20).fit(x)
    _, params, arrays = jm._artifacts()
    pm = port.kmeans_model_from_jax_arrays(**arrays, **params)
    d2 = ((x.astype(np.float64)[:, None, :] - pm.cluster_centers[None]) ** 2).sum(-1)
    d2.sort(axis=1)
    tie_free = x[d2[:, 1] - d2[:, 0] > 1e-3]
    return jm, pm, tie_free


@pytest.fixture(scope="module")
def refit(km):
    """A second port KMeans on the same rows (the swap's successor), its
    predictions different from the first's on the probe rows."""
    _, pm, x = km
    succ = port.KMeans(k=K, seed=7, max_iter=2).fit(x, device="cpu")
    return succ


def make_fleet(model, n=4, **kw):
    kw.setdefault("max_queue_rows", 256)
    kw.setdefault("devices", ("cpu",) * n)
    fs = F.ReplicaSet(n_replicas=n, **kw)
    fs.add_model("km", model, buckets=BUCKETS)
    return fs


def predict_np(model, x) -> np.ndarray:
    return model.predict(torch.from_numpy(np.ascontiguousarray(x, np.float32))).numpy()


def _profile(mod, **kw):
    kw.setdefault("base_rate_rps", 200.0)
    kw.setdefault("tenants", (
        mod.TenantMix("A", 2.0, "interactive", 2),
        mod.TenantMix("B", 1.0, "batch", 4),
        mod.TenantMix("C", 1.0, "best_effort", 8),
    ))
    return mod.LoadProfile(**kw)


# ======================================================= host pieces == JAX
@pytest.mark.parametrize("n_dev,n_rep", [(8, 4), (8, 3), (7, 2), (4, 4), (1, 4), (2, 5), (3, 1)])
def test_partition_devices_equals_the_reference(n_dev, n_rep):
    devs = list(range(100, 100 + n_dev))
    assert partition_devices(devs, n_rep) == jax_partition_devices(devs, n_rep)
    mine = F.EvenPlacement().assign(n_rep, devs)
    ref = JF.EvenPlacement().assign(n_rep, devs)
    assert [(s.replica_id, s.devices, s.primary) for s in mine] == [
        (s.replica_id, s.devices, s.primary) for s in ref]
    assert F.EvenPlacement().describe(n_rep, devs) == JF.EvenPlacement().describe(n_rep, devs)


@pytest.mark.parametrize("bad", [(0, [1, 2]), (2, [])])
def test_partition_devices_refuses_like_the_reference(bad):
    n, devs = bad
    with pytest.raises(ValueError) as mine:
        partition_devices(devs, n)
    with pytest.raises(ValueError) as ref:
        jax_partition_devices(devs, n)
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("pins", [
    {0: (3, 2), 1: (0,), 2: (1,)},           # valid
    {0: (0,)},                               # replica 1 missing
    {0: (0, 1), 1: (1,), 2: (2,)},           # device 1 pinned twice
    {0: (9,), 1: (0,), 2: (1,)},             # outside the list
    {0: (), 1: (0,), 2: (1,)},               # zero devices
])
def test_pinned_placement_equals_the_reference(pins):
    devs = [10, 11, 12, 13]
    n = 3 if len(pins) > 1 else 2
    outcomes = []
    for mod in (F, JF):
        try:
            outcomes.append([(s.replica_id, s.devices)
                             for s in mod.PinnedPlacement(pins).assign(n, devs)])
        except ValueError as e:
            outcomes.append(("ValueError", str(e)))
    assert outcomes[0] == outcomes[1]


def test_ring_preference_equals_the_reference_across_membership_changes():
    keys = [f"hospital-{i}" for i in range(1000)]
    rings = (F.ConsistentHashRing(vnodes=160), JF.ConsistentHashRing(vnodes=160))
    for r in rings:
        for rid in range(4):
            r.add(rid)

    def prefs():
        out = [[r.preference(k) for k in keys] for r in rings]
        assert out[0] == out[1]
        assert [r.members() for r in rings][0] == rings[1].members()
        return out[0]

    before = prefs()
    for r in rings:
        r.remove(2)
    removed = prefs()
    assert all(2 not in p for p in removed)
    for r in rings:
        r.add(2)
    assert prefs() == before
    assert rings[0].generation == rings[1].generation == 6


class _Stub:
    def __init__(self, index, load=0, healthy=True, open_models=()):
        self.index = index
        self._load = load
        self._healthy = healthy
        self._open = set(open_models)

    def healthy(self):
        return self._healthy

    def load_rows(self):
        return self._load

    def breaker_open(self, model):
        return model in self._open


@pytest.mark.parametrize("policy", ["least_loaded", "consistent_hash"])
def test_router_routes_like_the_reference(policy):
    """The same loads, health and breaker states through both routers:
    the same replica for every tenant, model and state change, and the
    same refusal when none is eligible."""
    states = [
        [(0, 50, True, ()), (1, 5, True, ()), (2, 20, True, ()), (3, 5, True, ())],
        [(0, 50, True, ()), (1, 5, True, ("m",)), (2, 20, True, ()), (3, 7, True, ())],
        [(0, 50, False, ()), (1, 5, True, ("m",)), (2, 20, True, ()), (3, 7, False, ())],
    ]
    tenants = [None] + [f"t{i}" for i in range(120)]
    picks = []
    for mod in (F, JF):
        out = []
        for st in states:
            reps = [_Stub(i, load, ok, op) for i, load, ok, op in st]
            router = mod.Router(reps, policy=policy)
            for model in ("m", "other", None):
                out.append([router.route(tenant_id=t, model=model).index for t in tenants])
            router.remove_replica(2)
            out.append([router.route(tenant_id=t, model="other").index for t in tenants])
        dead = [_Stub(0, 0, False), _Stub(1, 0, True, ("m",))]
        with pytest.raises(mod.NoReplicaAvailable) as e:
            mod.Router(dead, policy=policy).route(tenant_id="a", model="m")
        out.append(str(e.value))
        picks.append(out)
    assert picks[0] == picks[1]
    with pytest.raises(ValueError, match="unknown policy"):
        F.Router([], policy="random")


def test_token_bucket_equals_the_reference_on_an_injected_clock():
    rng = np.random.default_rng(3)
    now = [0.0]
    buckets = [mod.TokenBucket(rate=100.0, burst=50.0, clock=lambda: now[0]) for mod in (F, JF)]
    trail = []
    for _ in range(300):
        now[0] += float(rng.exponential(0.02))
        rows = int(rng.integers(1, 20))
        got = [b.take(rows) for b in buckets]
        trail.append(got[0])
        assert got[0] == got[1]
        assert buckets[0].tokens == buckets[1].tokens
    assert any(trail) and not all(trail)
    for mod in (F, JF):
        with pytest.raises(ValueError):
            mod.TokenBucket(rate=0.0, burst=1.0)


def test_admission_ladder_equals_the_reference_on_a_grid():
    """Admit/shed decisions over (SLO class, load factor, tenant quota)
    with an injected clock: the same decision, reason and deadline at
    every point, the quota charged only for what the ladder admits."""
    now = [0.0]
    quotas = {"noisy": (100.0, 16.0), "tiny": (5.0, 4.0)}
    ctls = [mod.AdmissionController(tenant_quotas=quotas, default_quota=(1000.0, 64.0),
                                    clock=lambda: now[0]) for mod in (F, JF)]
    assert {k: (c.name, c.shed_load, c.default_deadline_s)
            for k, c in ctls[0].classes.items()} == {
        k: (c.name, c.shed_load, c.default_deadline_s) for k, c in ctls[1].classes.items()}
    n = 0
    for slo in ("interactive", "batch", "best_effort"):
        for load in (0.0, 0.1, 0.249, 0.25, 0.3, 0.449, 0.45, 0.6, 0.99, 1.0):
            for tenant in ("noisy", "tiny", "other", None):
                for rows in (1, 8):
                    now[0] += 0.01
                    a, b = (c.admit(tenant, slo, rows, load) for c in ctls)
                    assert (a.admitted, a.reason, a.deadline_s) == (
                        b.admitted, b.reason, b.deadline_s), (slo, load, tenant, rows)
                    n += a.admitted
    assert 0 < n < 3 * 10 * 4 * 2
    for c in ctls:
        c.set_shed_load("batch", 0.2)
        c.set_quota("noisy", 1.0, 1.0)
    a, b = (c.admit("noisy", "batch", 1, 0.1) for c in ctls)
    assert (a.admitted, a.reason) == (b.admitted, b.reason) == (True, "")
    a, b = (c.admit("noisy", "batch", 1, 0.1) for c in ctls)
    assert (a.admitted, a.reason) == (b.admitted, b.reason) == (False, "quota:noisy")
    for c in ctls:
        with pytest.raises(ValueError, match="unknown SLO class"):
            c.admit("t", "platinum", 1, 0.0)
        with pytest.raises(ValueError, match="unknown SLO class"):
            c.set_shed_load("platinum", 0.5)


def test_build_schedule_equals_the_reference_bit_for_bit():
    kw = dict(seed=7, base_rate_rps=400.0, diurnal_amplitude=0.4, diurnal_period_s=2.0,
              diurnal_phase=0.3, burst_start_s=0.5, burst_dur_s=0.25, burst_mult=2.0)
    mine = F.build_schedule(_profile(F, **kw), 3.0)
    ref = JF.build_schedule(_profile(JF, **kw), 3.0)
    assert len(mine) > 500
    assert [(a.t, a.tenant_id, a.slo, a.rows) for a in mine] == [
        (a.t, a.tenant_id, a.slo, a.rows) for a in ref]
    p, q = _profile(F, **kw), _profile(JF, **kw)
    for t in (0.0, 0.6, 1.3, 2.9):
        assert p.rate_at(t) == q.rate_at(t)
    assert p.peak_rate == q.peak_rate
    for mod in (F, JF):
        with pytest.raises(ValueError, match="diurnal_amplitude"):
            _profile(mod, diurnal_amplitude=1.0)


def test_class_report_summary_equals_the_reference():
    rng = np.random.default_rng(5)
    reps = [mod.ClassReport() for mod in (F, JF)]
    for r in reps:
        r.offered_requests, r.offered_rows = 40, 400
        r.shed_rows, r.deadline_rows, r.other_rows = 30, 20, 5
    lat = rng.exponential(0.02, 200)
    rows = rng.integers(1, 16, 200)
    for r in reps:
        r.ok_rows = int(rows.sum())
        r.ok_samples = [(float(a), int(b)) for a, b in zip(lat, rows)]
    assert reps[0].summary() == reps[1].summary()
    for pin in (0.005, 0.03, 1.0):
        assert reps[0].in_slo(pin) == reps[1].in_slo(pin)
    assert F.ClassReport().summary() == JF.ClassReport().summary()


# =================================================== the in-process fleet
def test_fleet_answers_equal_the_jax_models_assignments(km):
    jm, pm, x = km
    want = np.asarray(jm.predict(x[:64]))
    fs = make_fleet(pm)
    with fs:
        got = [fs.predict("km", x[i:i + 8], tenant_id=f"H{i}") for i in range(0, 64, 8)]
    assert all(r.ok for r in got)
    assert np.array_equal(np.concatenate([r.value for r in got]), want)
    assert len({fs.router.route(tenant_id=f"H{i}", model="km").index
                for i in range(0, 64, 8)}) > 1


def test_replicas_serve_on_their_slices_device(km):
    _, pm, x = km
    fs = make_fleet(pm)
    assert [str(r.slice.primary) for r in fs.replicas] == list(CPU4)
    assert fs.device == torch.device("cpu")
    with fs:
        for r in fs.replicas:
            sm = r.server.registry.get("km")
            assert sm.device == torch.device("cpu") == r.server.device
            assert sm.predict(x[:3]).shape == (3,)


def test_sticky_failover_returns_home_after_a_revive(km, refit):
    """Kill a replica, swap the fleet while it is dead, revive it: its
    tenants failed over to their ring successors and come home, and the
    revived replica serves the post-kill swap."""
    _, pm, x = km
    fs = make_fleet(pm)
    with fs:
        tenants = [f"H{i:03d}" for i in range(80)]
        home = {t: fs.router.route(tenant_id=t, model="km").index for t in tenants}
        victims = [t for t in tenants if home[t] == 1]
        assert victims
        fs.kill_replica(1)
        over = {t: fs.router.route(tenant_id=t, model="km").index for t in tenants}
        assert all(over[t] != 1 for t in victims)
        assert all(over[t] == home[t] for t in tenants if home[t] != 1)
        again = {t: fs.router.route(tenant_id=t, model="km").index for t in victims}
        assert again == {t: over[t] for t in victims}
        fs.swap_model("km", refit)
        fs.revive_replica(1)
        assert fs.replicas[1].server.registry.get("km").model is refit
        assert {t: fs.router.route(tenant_id=t, model="km").index for t in tenants} == home
        r = fs.predict("km", x[:2], tenant_id=victims[0])
        assert r.ok and np.array_equal(r.value, predict_np(refit, x[:2]))
        h = fs.health()
        assert h["replicas"]["r01"]["state"] == "live" and h["status"] == "ok"
        assert (h["replicas_killed"], h["replicas_revived"], h["promotions"]) == (1, 1, 1)
        with pytest.raises(ValueError, match="not dead"):
            fs.revive_replica(1)


def test_swap_flips_every_replica_or_none(km, refit):
    _, pm, x = km
    probe = x[:8]
    old, new = predict_np(pm, probe), predict_np(refit, probe)
    assert not np.array_equal(old, new)
    fs = make_fleet(pm)
    with fs:
        plan = faults.FaultPlan().fail(
            "fleet.swap.prepare", when=lambda ctx: ctx.get("replica") == 1,
            error=lambda: RuntimeError("injected prepare failure"))
        with faults.active(plan):
            with pytest.raises(RuntimeError, match="injected"):
                fs.swap_model("km", refit)
        assert plan.fired("fleet.swap.prepare") == 1
        for r in fs.replicas:  # replica 0 had prepared: none may flip
            assert r.server.registry.get("km").model is pm
            assert np.array_equal(r.server.predict("km", probe).value, old)
        assert fs.health()["promotions"] == 0
        fs.swap_model("km", refit)
        for r in fs.replicas:
            assert np.array_equal(r.server.predict("km", probe).value, new)
        assert fs.health()["promotions"] == 1


def test_the_commit_loop_fires_no_per_replica_swap_site(km, refit):
    """The fleet's commit loop calls ``commit_swap(fire_fault_point=False)``:
    a plan armed at the single server's ``lifecycle.registry.swap`` site
    never fires inside it, while a lone server's swap still fires it."""
    _, pm, _ = km
    fs = make_fleet(pm, n=2)
    with fs:
        plan = faults.FaultPlan().crash("lifecycle.registry.swap")
        with faults.active(plan):
            fs.swap_model("km", refit)
            assert plan.fired("lifecycle.registry.swap") == 0
            srv = fs.replicas[0].server
            with pytest.raises(faults.InjectedCrash):
                srv.commit_swap(srv.prepare_swap("km", pm))
        assert all(r.server.registry.get("km").model is refit for r in fs.replicas)


def test_swap_resets_breakers_fleet_wide(km):
    _, pm, _ = km
    fs = make_fleet(pm, n=2)
    with fs:
        for r in fs.replicas:
            r.server._breaker_for("km").trip("test drift")
            assert r.breaker_open("km")
        assert fs.health()["status"] == "degraded"
        fs.swap_model("km", pm)
        assert not any(r.breaker_open("km") for r in fs.replicas)
        assert fs.health()["status"] == "ok"


def test_quota_sheds_only_the_noisy_tenant(km):
    _, pm, _ = km
    now = [0.0]
    ctl = F.AdmissionController(tenant_quotas={"noisy": (100.0, 16.0)}, clock=lambda: now[0])
    fs = make_fleet(pm, n=2, admission=ctl)
    with fs:
        res = [fs.predict("km", np.zeros((8, D), np.float32), tenant_id="noisy")
               for _ in range(8)]
        assert [r.ok for r in res] == [True, True] + [False] * 6
        assert all(r.status == STATUS_REJECTED and "quota:noisy" in r.detail for r in res[2:])
        assert all(fs.predict("km", np.zeros((8, D), np.float32), tenant_id="quiet").ok
                   for _ in range(8))
        h = fs.health()
    assert (h["shed_quota"], h["shed"]["interactive"], h["shed_load"]) == (6, 6, 0)


def test_unknown_slo_is_refused_before_anything_is_counted(km):
    _, pm, _ = km
    for admission in (F.DEFAULT_ADMISSION, None):
        fs = make_fleet(pm, n=1, admission=admission)
        with fs:
            with pytest.raises(ValueError, match="unknown SLO class"):
                fs.predict("km", np.zeros((1, D), np.float32), slo="platinum")
            with pytest.raises(KeyError, match="not served"):
                fs.predict("nope", np.zeros((1, D), np.float32))
        assert "platinum" not in str(fs.metrics.counters)
        assert fs.metrics.counters.get("fleet.requests", 0) == 0


def test_the_latency_histogram_excludes_shed_answers(km):
    _, pm, _ = km
    ctl = F.AdmissionController(tenant_quotas={"t": (1.0, 8.0)})
    fs = make_fleet(pm, n=1, admission=ctl)
    with fs:
        assert fs.predict("km", np.zeros((8, D), np.float32), tenant_id="t").ok
        for _ in range(3):
            assert not fs.predict("km", np.zeros((8, D), np.float32), tenant_id="t").ok
        h = fs.metrics.histograms['fleet.latency_seconds{slo="interactive"}']
        assert h.count == 1


def test_a_replica_killed_mid_load_leaves_none_unanswered(km):
    _, pm, x = km
    fs = make_fleet(pm, n=3, max_queue_rows=512)
    sched = F.build_schedule(_profile(F, seed=5, base_rate_rps=400.0), 1.5)
    killed = threading.Event()

    def kill():
        fs.kill_replica(1)
        killed.set()

    with fs:
        rep = F.replay(
            lambda a: fs.submit("km", x[: a.rows], tenant_id=a.tenant_id, slo=a.slo),
            sched, speed=1.5, mid_hook=kill)
        assert killed.is_set()
        for t in ("A", "B", "C", "D", "E"):
            r = fs.predict("km", x[:2], tenant_id=t)
            assert r.ok and np.array_equal(r.value, predict_np(pm, x[:2]))
        h = fs.health()
    assert rep["unanswered"] == 0 and rep["ok_rows"] > 0
    total = sum(c["ok_rows"] + c["shed_rows"] + c["deadline_rows"] + c["other_rows"]
                for c in rep["per_class"].values())
    assert total == rep["offered_rows"]
    assert h["replicas"]["r01"]["state"] == "dead" and h["replicas_killed"] == 1
    assert h["status"] == "degraded"


def test_drain_answers_everything_then_stops(km):
    _, pm, x = km
    fs = make_fleet(pm, n=2)
    with fs:
        reqs = [fs.submit("km", x[:2], tenant_id=f"t{i}") for i in range(20)]
        assert fs.drain_replica(0, timeout_s=5.0)
        for req in reqs:
            assert req.wait(5.0).status in ("ok", "shutdown", "rejected")
        assert fs.replicas[0].state == "dead"
        assert fs.predict("km", x[:2]).ok
        assert fs.remove_replica(0, timeout_s=0.1) is True
        assert 0 not in fs.router.ring.members()


def test_replay_events_fire_once_in_schedule_order(km):
    _, pm, x = km
    fs = make_fleet(pm, n=2)
    sched = F.build_schedule(_profile(F, seed=2), 1.0)
    fired = []
    events = [(0.25, lambda: fired.append(0.25)), (0.5, lambda: fired.append(0.5)),
              (0.0, lambda: fired.append(0.0)), (99.0, lambda: fired.append(99.0))]
    with fs:
        rep = F.replay(
            lambda a: fs.submit("km", x[: a.rows], tenant_id=a.tenant_id, slo=a.slo),
            sched, speed=4.0, events=events)
    assert fired == [0.0, 0.25, 0.5, 99.0]
    assert rep["unanswered"] == 0 and rep["offered_requests"] == len(sched)


def test_best_effort_sheds_before_interactive_under_load(km):
    _, pm, _ = km
    fs = F.ReplicaSet(n_replicas=1, devices=("cpu",), max_queue_rows=64)
    fs.add_model("km", pm, buckets=BUCKETS)
    with fs:
        fs.replicas[0].load_rows = lambda: 32  # load factor 0.5, pinned
        z = np.zeros((1, D), np.float32)
        be = fs.predict("km", z, tenant_id="t", slo="best_effort")
        batch = fs.predict("km", z, tenant_id="t", slo="batch")
        inter = fs.predict("km", z, tenant_id="t", slo="interactive")
        assert be.status == batch.status == STATUS_REJECTED
        assert "slo_load:best_effort" in be.detail and "slo_load:batch" in batch.detail
        assert inter.ok
        assert fs.health()["shed"] == {"best_effort": 1, "batch": 1, "interactive": 0}


def test_predict_tenant_routes_a_farm_sticky_and_refuses_a_plain_model(km):
    _, pm, _ = km
    rng = np.random.default_rng(9)
    data = {str(t): (rng.normal(size=(12, D)), rng.normal(size=12)) for t in range(6)}
    farm = port.farm.FarmLinearRegression().fit(data, device="cpu")
    assert farm.affinity_key(3) == farm.affinity_key("3") == "3"
    fs = F.ReplicaSet(n_replicas=2, devices=("cpu", "cpu"), max_queue_rows=256)
    fs.add_model("farm", farm, buckets=BUCKETS)
    fs.add_model("km", pm, buckets=BUCKETS)
    x = data["3"][0][:2]
    with fs:
        home = fs.router.route(tenant_id="3", model="farm").index
        res = fs.predict_tenant("farm", 3, x)
        assert res.ok
        np.testing.assert_array_equal(res.value, farm.predict_tenant("3", x, device="cpu"))
        served = [r.server.metrics.registry.counters.get("serve.requests", 0)
                  for r in fs.replicas]
        assert served[home] == 1 and served[1 - home] == 0
        plain = fs.predict_tenant("km", "3", x)
        assert plain.status == STATUS_INVALID_INPUT and "km" in plain.detail


def test_health_key_sets_equal_the_reference(km):
    jm, pm, _ = km
    ref = JF.ReplicaSet(n_replicas=2, max_queue_rows=64)
    ref.add_model("km", jm, buckets=BUCKETS)
    fs = make_fleet(pm, n=2)
    with fs:
        for _ in range(3):
            assert fs.predict("km", np.zeros((4, D), np.float32)).ok
        fs.replicas[1].server._breaker_for("km").trip("drifted")
        h = fs.health()
    want = ref.health()
    assert set(h) == set(want)
    assert {k for rep in h["replicas"].values() for k in rep} == {
        k for rep in want["replicas"].values() for k in rep}
    assert set(h["replicas"]) == {"r00", "r01"}
    assert h["replicas"]["r01"]["breakers"]["km"] == "open" and h["status"] == "degraded"
    assert (h["requests"], h["served_requests"]) == (3, 3)
    snap = fs.stats()
    assert 'fleet.breaker_state{model="km",replica="r01"}' in snap["gauges"]
    assert 'fleet.replica_state{replica="r00"}' in snap["gauges"]


def test_one_routed_trace_spans_the_fleet_the_router_and_the_replica(km):
    _, pm, x = km
    tracer = trace.Tracer()
    fs = make_fleet(pm, n=2)
    with fs:
        with trace.active(tracer):
            r = fs.predict("km", x[:4], tenant_id="H00")
    assert r.ok
    root = [s for s in tracer.spans if s["name"] == "fleet.request"]
    assert len(root) == 1
    chain = trace.timeline(tracer.spans, root[0]["trace_id"])
    assert {"fleet.request", "router.route", "serve.request"} <= {s["name"] for s in chain}
    assert root[0]["attrs"]["replica"] in ("r00", "r01")


def test_fleet_exposes_the_lifecycle_controller_surface(km):
    _, pm, _ = km
    fs = make_fleet(pm, n=2)
    assert fs.registry.names() == ["km"] and fs.registry.get("km").model is pm
    sentinel = object()
    fs.attach_lifecycle(sentinel)
    assert all(r.server._lifecycle is sentinel for r in fs.replicas)
    assert fs.set_max_wait_s(0.004) == 0  # not started: no batcher moved
    with fs:
        assert fs.set_max_wait_s(0.003) == 2
        assert all(r.server._batchers["km"].max_wait_s == 0.003 for r in fs.replicas)


def test_the_watchdog_sees_no_stall_on_a_working_fleet(km):
    _, pm, x = km
    fs = make_fleet(pm, n=2)
    wd = F.StallWatchdog(window_s=1.0, poll_s=0.02)
    wd.watch_fleet(fs)
    with fs, wd:
        for i in range(30):
            assert fs.predict("km", x[:4], tenant_id=f"t{i}").ok
        time.sleep(1.2)  # idle past the window: empty queues are not a stall
        wd.check()
    assert wd.stalled() is None


# ======================================================= across the packages
def _payload():
    rng = np.random.default_rng(2)
    return {"op": "predict", "id": 7, "x": rng.normal(size=(5, 3)).astype(np.float32),
            "rows": np.arange(4, dtype=np.int64), "deadline_s": 0.03, "name": "km",
            "flag": True, "none": None}


@pytest.mark.parametrize("writer,reader", [(FP, JFP), (JFP, FP)], ids=["port_to_jax", "jax_to_port"])
def test_a_frame_crosses_the_packages(writer, reader):
    a, b = socket.socketpair()
    with a, b:
        writer.send_frame(a, _payload())
        writer.send_frame(a, {"op": "exit"})
        got, nxt = reader.recv_frame(b), reader.recv_frame(b)
    want = _payload()
    assert sorted(got) == sorted(want) and nxt == {"op": "exit"}
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v)
        else:
            assert got[k] == v
    assert FP.MAX_FRAME_BYTES == JFP.MAX_FRAME_BYTES and FP._MAGIC == JFP._MAGIC == b"CMP1"


def _stall(mod, flight_dir, monkeypatch):
    monkeypatch.setenv("CMLHN_FLIGHT_DIR", str(flight_dir))
    wd = mod.StallWatchdog(window_s=0.1, poll_s=0.01)
    wd.register("stuck", lambda: 3.0)
    with wd:
        deadline = time.monotonic() + 5.0
        while wd.stalled() is None and time.monotonic() < deadline:
            time.sleep(0.01)
    err = wd.stalled()
    assert isinstance(err, mod.StallError) and err.stage == "stuck"
    with pytest.raises(mod.StallError):
        wd.check()
    return err


def test_the_watchdog_stall_dump_reads_in_the_reference(tmp_path, monkeypatch):
    mine = _stall(F, tmp_path / "port", monkeypatch)
    ref = _stall(JF, tmp_path / "jax", monkeypatch)
    got, want = jax_read_dump(mine.dump_path), jax_read_dump(ref.dump_path)
    assert got["site"] == want["site"] == "watchdog.stall"
    assert got["trigger"] == want["trigger"] == {
        "stage": "stuck", "window_s": 0.1, "last_progress": 3.0}
    assert set(got) == set(want)


# ======================================================= pickling
def _tensors(obj, seen=None) -> list:
    """Every torch.Tensor reachable through dicts, lists, tuples and
    instance ``__dict__``s of ``obj``."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        items = list(obj.values())
    elif isinstance(obj, (list, tuple, set)):
        items = list(obj)
    elif hasattr(obj, "__dict__"):
        items = list(vars(obj).values())
    else:
        return []
    return [t for it in items for t in _tensors(it, seen)]


@pytest.mark.parametrize("family", ["kmeans", "farm"])
def test_a_served_model_pickles_without_its_device_cache(km, family):
    _, pm, x = km
    if family == "kmeans":
        model, name, rows = pm, "m", x[:8]
    else:
        rng = np.random.default_rng(4)
        data = {f"h{t}": (rng.normal(size=(10, D)), rng.normal(size=10)) for t in range(3)}
        model, name = port.farm.FarmLinearRegression().fit(data, device="cpu"), "m"
        rows = model.route_request("h1", x[:8])
    srv = port.serve.InferenceServer(device="cpu")
    srv.add_model(name, model, buckets=BUCKETS)
    with srv:
        before = srv.predict(name, rows).value
    assert _tensors(model)                # serving filled the device cache
    state = model.__getstate__()
    assert _tensors(state) == []
    back = pickle.loads(pickle.dumps(model))
    assert _tensors(back) == []
    srv2 = port.serve.InferenceServer(device="cpu")
    srv2.add_model(name, back, buckets=BUCKETS)
    with srv2:
        after = srv2.predict(name, rows).value
    assert np.array_equal(before, after)


# ======================================================= the lifecycle over a fleet
LC_FEATS = ("f0", "f1", "f2")
LC_BLOBS = np.array([[0, 0, 0], [4, 0, 0], [0, 4, 0], [4, 4, 4]], dtype=np.float64)
LC_STATES = ["serving", "drift_suspected", "retraining", "shadow", "canary", "promoted",
             "serving"]
# the promoted centers against the JAX package's: the retrain's float32
# Lloyd sums run in another order over the same 600 drifted rows
# (``tests/test_torch_lifecycle.py``'s CENTER_TOL, measured 2.9e-6 there)
CENTER_TOL = 3e-5

LC_SIDES = {
    "port": {"pkg": port, "lc": PL, "faults": faults, "dev": {"device": "cpu"},
             "stream": {"device": "cpu"}, "fleet": {"devices": ("cpu", "cpu")}},
    "jax": {"pkg": J, "lc": JL, "faults": jfaults, "dev": {},
            "stream": {"add_ingest_time": False}, "fleet": {}},
}


def _blobs(rng, n, shift=0.0):
    return (LC_BLOBS + shift)[rng.integers(0, 4, n)] + rng.normal(scale=0.3, size=(n, 3))


@pytest.fixture(scope="module")
def lc_base():
    """The lifecycle tests' baseline: a JAX KMeans(k=4) on the blobs, the
    same model carried to the port, and its training rows: both packages
    start from one v0."""
    x0 = _blobs(np.random.default_rng(0), 1500).astype(np.float32)
    jm = J.models.kmeans.KMeans(k=4, seed=0, max_iter=20).fit(x0)
    _, params, arrays = jm._artifacts()
    return {"jax": jm, "port": port.kmeans_model_from_jax_arrays(**arrays, **params),
            "x0": x0}


def _lc_world(work, base, server, fresh=True, side="port"):
    """``side``'s controller over ``server`` (a single server or a fleet)
    and a stream over ``work``; ``fresh`` bootstraps v0 and ingests the
    drifted drops."""
    S = LC_SIDES[side]
    pkg, lc = S["pkg"], S["lc"]
    x0 = base["x0"]
    schema = lc.feedback_schema(LC_FEATS)
    st = pkg.streaming
    os.makedirs(os.path.join(work, "incoming"), exist_ok=True)
    stream = st.StreamExecution(
        source=st.FileStreamSource(os.path.join(work, "incoming"), schema),
        sink=st.UnboundedTable(os.path.join(work, "table"), schema),
        checkpoint=st.StreamCheckpoint(os.path.join(work, "ckpt")), **S["stream"])
    ctrl = lc.LifecycleController(
        os.path.join(work, "lc"), server, "kmeans",
        lc.KMeansRetrainer(LC_FEATS, k=4, max_iter=30, tol=1e-4, **S["dev"]),
        stream=stream, buckets=(1, 8, 32), drift_window_rows=64, drift_trip_after=2,
        shadow_min_rows=128, canary_fraction=0.25, canary_min_rows=32, eval_rows=128)
    server.attach_lifecycle(ctrl)
    if fresh:
        ctrl.bootstrap(base[side], pkg.quality.DataProfile.from_matrix(
            x0.astype(np.float64), LC_FEATS), train_x=x0)
        drng = np.random.default_rng(7)
        for i in range(2):
            x = _blobs(drng, 300, 6.0)
            cols = {n: x[:, j] for j, n in enumerate(LC_FEATS)}
            cols["prediction"] = np.zeros(len(x))
            cols["outcome"] = np.zeros(len(x))
            pkg.io.write_csv(pkg.Table.from_dict(cols, schema),
                             os.path.join(work, "incoming", f"drift-{i}.csv"))
        while stream.run_once() is not None:
            pass
    return ctrl


def _lc_drive(server, ctrl, trng, max_steps=800):
    """8-row drifted requests and a poll() after each until PROMOTED.
    When the fleet's router refused a request because every replica's
    drift breaker is open, the next request waits out the breakers'
    0.1 s recovery: the router's refusals never reach the lifecycle
    (``test_the_routers_refusals_are_not_observed_by_the_lifecycle``)."""
    for _ in range(max_steps):
        r = server.predict("kmeans", _blobs(trng, 8, 6.0).astype(np.float32),
                           wait_timeout_s=10.0)
        if r.status == "unavailable" and "no healthy replica" in r.detail:
            time.sleep(0.1)
        ctrl.poll()
        if ctrl.state == "serving" and (ctrl.active_version or 0) > 0:
            return
    raise AssertionError(f"never promoted; state={ctrl.state}")


def _lc_centers(work, version, side="port"):
    return np.asarray(LC_SIDES[side]["pkg"].load_model(
        os.path.join(work, "lc", "models", f"v{version}")).cluster_centers)


def _served_centers(fleet):
    return [np.asarray(r.server.registry.get("kmeans").model.cluster_centers)
            for r in fleet.replicas]


def _lc_fleet(side="port"):
    mod = F if side == "port" else JF
    return mod.ReplicaSet(n_replicas=2, breaker_recovery_s=0.1, **LC_SIDES[side]["fleet"])


def _lc_killed(work, base, side="port"):
    """Kill ``side``'s fleet promotion at ``fleet.swap.commit``, then
    restart the controller over the same fleet; → (the v0 centers, the
    replicas' centers after the kill, the journal's states after the
    restart, the replicas' centers after it, the fleet's answer status
    after it, whether every replica carries the restarted controller)."""
    Fa = LC_SIDES[side]["faults"]
    fs = _lc_fleet(side)
    ctrl = _lc_world(work, base, fs, side=side)
    v0 = _lc_centers(work, 0, side)
    plan = Fa.FaultPlan().crash("fleet.swap.commit")
    with fs:
        with Fa.active(plan):
            with pytest.raises(Fa.InjectedCrash):
                _lc_drive(fs, ctrl, np.random.default_rng(1))
        assert plan.fired("fleet.swap.commit") == 1
        assert ctrl.journal.last()["state"] == "promoted"
        killed = _served_centers(fs)
        restarted = _lc_world(work, base, fs, fresh=False, side=side)      # the restart
        assert restarted.active_version == 1
        out = {"v0": v0, "killed": killed,
               "journal": [e["state"] for e in restarted.journal.entries()],
               "restarted": _served_centers(fs),
               "attached": all(r.server._lifecycle is restarted for r in fs.replicas),
               "status": fs.predict("kmeans", _blobs(np.random.default_rng(5), 8, 6.0)
                                    .astype(np.float32)).status}
    return out


@pytest.fixture(scope="module")
def jax_fleet_cycle(tmp_path_factory, lc_base):
    """The same seeded cycle run by the JAX package: its
    ``LifecycleController`` over ``JF.ReplicaSet(n_replicas=2)``,
    uninterrupted and killed at ``fleet.swap.commit``."""
    work = str(tmp_path_factory.mktemp("lc_jax_fleet"))
    fs = _lc_fleet("jax")
    ctrl = _lc_world(work, lc_base, fs, side="jax")
    with fs:
        _lc_drive(fs, ctrl, np.random.default_rng(1))
        served = _served_centers(fs)
    v1 = _lc_centers(work, 1, "jax")
    assert all(np.array_equal(c, v1) for c in served)
    flight = tmp_path_factory.mktemp("lc_jax_flight")
    old = os.environ.get("CMLHN_FLIGHT_DIR")
    os.environ["CMLHN_FLIGHT_DIR"] = str(flight)
    try:
        killed = _lc_killed(str(tmp_path_factory.mktemp("lc_jax_killed")), lc_base, "jax")
    finally:
        if old is None:
            os.environ.pop("CMLHN_FLIGHT_DIR", None)
        else:
            os.environ["CMLHN_FLIGHT_DIR"] = old
    return {"journal": [e["state"] for e in ctrl.journal.entries()], "v1": v1,
            "killed": killed}


def test_a_lifecycle_promotion_lands_on_every_replica(tmp_path, lc_base, jax_fleet_cycle):
    """One seeded cycle with a 2-replica fleet as the controller's server:
    the journal's states equal the single-server run's and the JAX
    package's over its own 2-replica fleet, and after PROMOTED every
    replica serves the candidate, within CENTER_TOL of the JAX fleet's."""
    srv = port.serve.InferenceServer(breaker_recovery_s=0.1, device="cpu")
    ctrl = _lc_world(str(tmp_path / "single"), lc_base, srv)
    with srv:
        _lc_drive(srv, ctrl, np.random.default_rng(1))
    single = [e["state"] for e in ctrl.journal.entries()]
    assert single == LC_STATES

    work = str(tmp_path / "fleet")
    fs = _lc_fleet()
    fctrl = _lc_world(work, lc_base, fs)
    assert fs.registry.names() == ["kmeans"]
    with fs:
        _lc_drive(fs, fctrl, np.random.default_rng(1))
        journal = [e["state"] for e in fctrl.journal.entries()]
        assert journal == single == jax_fleet_cycle["journal"]
        v1 = _lc_centers(work, 1)
        assert not np.array_equal(v1, _lc_centers(work, 0))
        assert np.abs(v1 - jax_fleet_cycle["v1"]).max() <= CENTER_TOL
        served = _served_centers(fs)
        assert all(np.array_equal(c, v1) for c in served)
        assert all(np.abs(c - jax_fleet_cycle["v1"]).max() <= CENTER_TOL for c in served)
        assert fs.health()["promotions"] >= 1
        probe = _blobs(np.random.default_rng(3), 8, 6.0).astype(np.float32)
        for r in fs.replicas:
            assert np.array_equal(r.server.predict("kmeans", probe).value,
                                  predict_np(port.KMeansModel(v1), probe))


def test_a_kill_at_the_fleet_commit_is_reapplied_on_every_replica(tmp_path, lc_base,
                                                                   jax_fleet_cycle,
                                                                   monkeypatch):
    """Kill the promotion at ``fleet.swap.commit``: no replica flipped.  A
    restarted controller over the same fleet recovers PROMOTED and its
    ``_install_active`` flips every replica, to the same artifact an
    uninterrupted fleet run promotes; the journal equals the JAX
    package's after the same kill and restart, and the re-applied centers
    lie within CENTER_TOL of the JAX fleet's."""
    ref_work = str(tmp_path / "ref")
    ref_fleet = _lc_fleet()
    ref_ctrl = _lc_world(ref_work, lc_base, ref_fleet)
    with ref_fleet:
        _lc_drive(ref_fleet, ref_ctrl, np.random.default_rng(1))
    want = _lc_centers(ref_work, 1)

    monkeypatch.setenv("CMLHN_FLIGHT_DIR", str(tmp_path / "flight"))
    got = _lc_killed(str(tmp_path / "killed"), lc_base)
    ref = jax_fleet_cycle["killed"]
    assert all(np.array_equal(c, got["v0"]) for c in got["killed"])      # none flipped
    assert all(np.array_equal(c, ref["v0"]) for c in ref["killed"])
    assert got["journal"] == ref["journal"]
    assert got["journal"][-2:] == ["promoted", "serving"]
    assert all(np.array_equal(c, want) for c in got["restarted"])
    assert all(np.abs(c - jax_fleet_cycle["v1"]).max() <= CENTER_TOL for c in got["restarted"])
    assert all(np.array_equal(c, jax_fleet_cycle["v1"]) for c in ref["restarted"])
    assert got["attached"] and ref["attached"]
    assert got["status"] == ref["status"] == "ok"


class _Observer:
    """A stand-in lifecycle controller that counts the hooks a server
    calls."""

    def __init__(self):
        self.requests = self.results = 0

    def on_request(self, name, x):
        self.requests += 1
        return None

    def on_result(self, name, x, result):
        self.results += 1


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_the_routers_refusals_are_not_observed_by_the_lifecycle(km, pkg):
    """Shared with the reference: with every replica's breaker open (a
    fleet-wide drift trip) the router refuses at the front door, and the
    attached lifecycle observes nothing, where a single server with its
    breaker open still passes the request through both hooks.  A
    controller over a fleet under sustained drift so sees only the
    requests of half-open probes and of the windows between re-trips."""
    jm, pm, x = km
    mod, model, kw = ((F, pm, {"devices": ("cpu", "cpu")}) if pkg == "port"
                      else (JF, jm, {}))
    obs = _Observer()
    fs = mod.ReplicaSet(n_replicas=2, max_queue_rows=64, breaker_recovery_s=60.0, **kw)
    fs.add_model("km", model, buckets=BUCKETS)
    fs.attach_lifecycle(obs)
    with fs:
        assert fs.predict("km", x[:4]).ok
        assert (obs.requests, obs.results) == (1, 1)
        for r in fs.replicas:
            r.server._breaker_for("km").trip("drift")
        refused = fs.predict("km", x[:4])
        assert refused.status == "unavailable" and "no healthy replica" in refused.detail
        assert (obs.requests, obs.results) == (1, 1)
        lone = fs.replicas[0].server.predict("km", x[:4])
        assert lone.status == "unavailable"
        assert (obs.requests, obs.results) == (2, 2)

"""The port's continuous-learning lifecycle (``lifecycle/``) and the
server's lifecycle hooks, against the JAX package on one seeded scenario
and against itself under kills, on the CPU.

The scenario is the reference tests' ``baseline``: a KMeans(k=4) over
four 3-d blobs, drifted by +6, driven by 8-row requests with a ``poll()``
after each.  Both packages start from the SAME v0 centers (the JAX fit,
carried to the port with ``convert.py``), see the same requests and
ingest the same drifted drops, so every host decision — the drift
monitor's windows, the journal, the canary stride, the gates — must be
equal; only the retrain's Lloyd sums run in another order.

Tolerances, each with its reason:

* ``CENTER_TOL`` = 3e-5: the retrain's centers (|c| up to about 10,
  where a float32 ulp is 9.5e-7) against the JAX package's, float32 Lloyd
  sums in another order over 600 rows; measured 2.9e-6, the bound 10x.
* ``OOC_TOL`` = 6e-5: the retrain out of core (``HostDataset`` blocks of
  512 rows) against resident on 3,000 rows, the block sums added in
  another order; measured 5.7e-6, the bound 10x.

Everything else is ``==``: the journal's states, cycles and versions, the
detection row, the canary split and statuses, the health keys, the
kill-and-resume artifacts, the rolled-back artifact's bytes.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port
from clustermachinelearningforhospitalnetworks_apache_spark_tpu import lifecycle as JL
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.utils import faults as jfaults
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import lifecycle as PL
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.serve import (
    DEGRADED_STATUSES,
    STATUS_CANARY,
    ServeResult,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import faults

# the suite runs several worker processes on a few cores: one intra-op
# thread per worker keeps torch from oversubscribing them
torch.set_num_threads(1)

CPU = "cpu"
FEATS = ("f0", "f1", "f2")
K = 4
SHIFT = 6.0
BLOB_CENTERS = np.array([[0, 0, 0], [4, 0, 0], [0, 4, 0], [4, 4, 4]], dtype=np.float64)
CENTER_TOL = 3e-5
OOC_TOL = 6e-5
CANARY_REQUESTS = 40
KILL_SITES = [
    "lifecycle.journal.append",
    "lifecycle.retrain.commit",
    "lifecycle.shadow.start",
    "lifecycle.registry.flip",
    "lifecycle.registry.swap",
]

SIDES = {
    "port": {"pkg": port, "lc": PL, "faults": faults, "dev": {"device": CPU},
             "stream": {"device": CPU}},
    "jax": {"pkg": J, "lc": JL, "faults": jfaults, "dev": {},
            "stream": {"add_ingest_time": False}},
}


def _blobs(rng, n, shift=0.0):
    idx = rng.integers(0, K, n)
    return (BLOB_CENTERS + shift)[idx] + rng.normal(scale=0.3, size=(n, 3))


@pytest.fixture(scope="module")
def baseline():
    """The reference tests' baseline, fitted once by the JAX package and
    carried to the port: (JAX model, port model, x0)."""
    x0 = _blobs(np.random.default_rng(0), 1500).astype(np.float32)
    jm = J.models.kmeans.KMeans(k=K, seed=0, max_iter=20).fit(x0)
    _, params, arrays = jm._artifacts()
    return jm, port.kmeans_model_from_jax_arrays(**arrays, **params), x0


def _build(side, work, retrainer=None, **over):
    """One process incarnation of ``side``'s server, stream and controller
    over the durable state in ``work``: calling it again IS the restart."""
    S = SIDES[side]
    pkg, lc = S["pkg"], S["lc"]
    incoming = os.path.join(work, "incoming")
    os.makedirs(incoming, exist_ok=True)
    schema = lc.feedback_schema(FEATS)
    st = pkg.streaming
    stream = st.StreamExecution(
        source=st.FileStreamSource(incoming, schema),
        sink=st.UnboundedTable(os.path.join(work, "table"), schema),
        checkpoint=st.StreamCheckpoint(os.path.join(work, "ckpt")), **S["stream"])
    srv = pkg.serve.InferenceServer(breaker_recovery_s=0.1, **S["dev"])
    kw = dict(stream=stream, buckets=(1, 8, 32), drift_window_rows=64, drift_trip_after=2,
              shadow_min_rows=128, canary_fraction=0.25, canary_min_rows=32, eval_rows=128)
    kw.update(over)
    ctrl = lc.LifecycleController(
        os.path.join(work, "lc"), srv, "kmeans",
        retrainer or lc.KMeansRetrainer(FEATS, k=K, max_iter=30, tol=1e-4, **S["dev"]), **kw)
    srv.attach_lifecycle(ctrl)
    return srv, stream, ctrl


def _seed_world(side, work, baseline, retrainer=None, **over):
    """Bootstrap v0 and ingest the whole drifted dataset up front, so the
    retrain snapshot is the same in every run."""
    jm, pm, x0 = baseline
    S = SIDES[side]
    srv, stream, ctrl = _build(side, work, retrainer, **over)
    profile = S["pkg"].quality.DataProfile.from_matrix(x0.astype(np.float64), FEATS)
    ctrl.bootstrap(pm if side == "port" else jm, profile, train_x=x0)
    drng = np.random.default_rng(7)
    schema = S["lc"].feedback_schema(FEATS)
    for i in range(2):
        x = _blobs(drng, 300, SHIFT)
        cols = {n: x[:, j] for j, n in enumerate(FEATS)}
        cols["prediction"] = np.zeros(len(x))
        cols["outcome"] = np.zeros(len(x))
        S["pkg"].io.write_csv(S["pkg"].Table.from_dict(cols, schema),
                           os.path.join(work, "incoming", f"drift-{i}.csv"))
    while stream.run_once() is not None:
        pass
    return srv, stream, ctrl


def _promoted(ctrl):
    return ctrl.state == "serving" and (ctrl.active_version or 0) > 0


def _rolled_back(ctrl):
    return ctrl.state == "serving" and any(
        e["state"] == "rolled_back" for e in ctrl.journal.entries())


def _drive(srv, ctrl, until, max_steps=600, seed=1, on_step=None):
    """Deterministic drifted traffic (8-row requests, a poll after each)
    until ``until(ctrl)``; → the step it held at."""
    trng = np.random.default_rng(seed)
    for step in range(max_steps):
        xb = _blobs(trng, 8, SHIFT).astype(np.float32)
        srv.predict("kmeans", xb, wait_timeout_s=10.0)
        if on_step is not None:
            on_step(step, ctrl)
        ctrl.poll()
        if until(ctrl):
            return step
    raise AssertionError(f"never reached; state={ctrl.state} cycle={ctrl.cycle}")


def _run(side, work, baseline, kill_site=None, until=_promoted, retrainer=None,
         make_retrainer=None):
    """A full cycle, restarting through each package's InjectedCrash as a
    supervisor would; → (controller, crashes)."""
    F = SIDES[side]["faults"]
    srv, _, ctrl = _seed_world(side, work, baseline, retrainer)
    srv.start()
    crashes = 0
    plan = None
    if kill_site:
        plan = F.FaultPlan().crash(kill_site)
        F.install(plan)
    try:
        while True:
            try:
                _drive(srv, ctrl, until)
                break
            except F.InjectedCrash:
                crashes += 1
                F.clear()
                srv.stop()
                srv, _, ctrl = _build(side, work, make_retrainer() if make_retrainer else None)
                srv.start()
    finally:
        F.clear()
        srv.stop()
    if kill_site:
        assert plan.fired(kill_site) >= 1, f"{kill_site} never fired"
        assert crashes >= 1
    return ctrl, crashes


def _scenario(side, work, baseline) -> dict:
    """The cross-package record: drive to DRIFT_SUSPECTED (the detection
    step), park in CANARY for ``CANARY_REQUESTS`` 4-row requests (their
    statuses, answers and the candidate's predict on the same rows, the
    health fragment and the lifecycle gauges), then promote."""
    out: dict = {}
    srv, _, ctrl = _seed_world(side, work, baseline, canary_min_rows=10**9)
    srv.start()
    try:
        def note(step, c):
            if c.state != "serving" and "detection_step" not in out:
                out["detection_step"] = step

        _drive(srv, ctrl, lambda c: c.state == "canary", on_step=note)
        trng = np.random.default_rng(11)
        out["statuses"], out["canary_pairs"] = [], []
        for _ in range(CANARY_REQUESTS):
            xb = _blobs(trng, 4, SHIFT).astype(np.float32)
            r = srv.predict("kmeans", xb, wait_timeout_s=10.0)
            out["statuses"].append(r.status)
            if r.status == STATUS_CANARY:
                out["canary_pairs"].append((r, ctrl._candidate_sm.predict(xb), xb))
        out["health_canary"] = srv.health()["lifecycle"]
        out["metrics_canary"] = srv.metrics_text()
        out["journal_canary"] = ctrl.journal.entries()
        ctrl.canary_min_rows = 32
        _drive(srv, ctrl, _promoted)
        out["health_end"] = srv.health()["lifecycle"]
        out["metrics_end"] = srv.metrics_text()
    finally:
        srv.stop()
    out["journal"] = ctrl.journal.entries()
    out["centers"] = np.asarray(
        SIDES[side]["pkg"].load_model(os.path.join(work, "lc", "models", "v1")).cluster_centers)
    return out


@pytest.fixture(scope="module")
def scenarios(tmp_path_factory, baseline):
    return {side: _scenario(side, str(tmp_path_factory.mktemp(f"lc_{side}")), baseline)
            for side in ("port", "jax")}


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory, baseline):
    """The port's uninterrupted cycle: the final v1 artifact's arrays."""
    work = str(tmp_path_factory.mktemp("lc_reference"))
    ctrl, crashes = _run("port", work, baseline)
    assert crashes == 0
    return _artifact_arrays(work, 1)


def _artifact_arrays(work, version) -> dict:
    with np.load(os.path.join(work, "lc", "models", f"v{version}", "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def _artifact_bytes(path) -> dict:
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def _gauges(text: str) -> dict:
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^(cmlhn_lifecycle_\w+(?:\{[^}]*\})?) (\S+)$", text, re.M)}


# ------------------------------------------------------------- the scenario
def test_the_journal_matches_the_reference(scenarios):
    """States, cycles, versions, the snapshot pin, the seed and the
    shadow's train rows — entry for entry."""
    def view(entries):
        keys = ("active_version", "candidate_version", "snapshot_batch_id", "seed",
                "train_rows", "warm_started", "reason")
        return [(e["seq"], e["state"], e["cycle"],
                 {k: e["info"][k] for k in keys if k in e["info"]}) for e in entries]

    got, want = view(scenarios["port"]["journal"]), view(scenarios["jax"]["journal"])
    assert got == want
    assert [s for _, s, _, _ in got] == ["serving", "drift_suspected", "retraining", "shadow",
                                         "canary", "promoted", "serving"]


def test_the_detection_row_matches_the_reference(scenarios):
    p, j = scenarios["port"], scenarios["jax"]
    assert p["detection_step"] == j["detection_step"]
    reasons = [[e["info"].get("reason") for e in s["journal"]
                if e["state"] == "drift_suspected"] for s in (p, j)]
    assert reasons[0] == reasons[1]


def test_the_canary_split_matches_the_reference(scenarios):
    """Counter-based split: every 4th request at fraction 0.25, the same
    statuses in the same order, and the PROMOTED entry's router counts."""
    p, j = scenarios["port"], scenarios["jax"]
    assert p["statuses"] == j["statuses"]
    assert p["statuses"].count(STATUS_CANARY) == CANARY_REQUESTS // 4
    canary = [e["info"]["canary"] for s in (p, j) for e in s["journal"]
              if e["state"] == "promoted"]
    assert canary[0] == canary[1] and canary[0]["stride"] == 4
    for key in ("fraction", "stride", "requests_seen", "routed_to_candidate"):
        assert p["health_canary"]["canary"][key] == j["health_canary"]["canary"][key], key


def test_the_health_fragment_keys_match_the_reference(scenarios):
    p, j = scenarios["port"], scenarios["jax"]
    for moment in ("health_canary", "health_end"):
        assert sorted(p[moment]) == sorted(j[moment]), moment
        for sub in ("shadow", "canary", "drift"):
            a, b = p[moment][sub], j[moment][sub]
            assert (a is None) == (b is None), (moment, sub)
            if a is not None:
                assert sorted(a) == sorted(b), (moment, sub)
    h = p["health_canary"]
    assert (h["phase"], h["candidate_version"], h["active_version"]) == ("canary", 1, 0)
    assert h["shadow"]["rows_observed"] >= 128 and h["candidate_model_id"] is not None


def test_the_final_centers_within_bound_of_the_reference(scenarios):
    got, want = scenarios["port"]["centers"], scenarios["jax"]["centers"]
    assert got.shape == want.shape == (K, 3)
    assert np.abs(got - want).max() <= CENTER_TOL


def test_canary_answers_equal_the_candidates_predict(scenarios):
    pairs = scenarios["port"]["canary_pairs"]
    assert len(pairs) == CANARY_REQUESTS // 4
    for r, cand, xb in pairs:
        assert r.ok and r.latency_s > 0.0 and r.detail == "candidate v1"
        assert np.array_equal(r.value, cand) and len(r.value) == len(xb)
    assert ServeResult(np.zeros(1), STATUS_CANARY).ok
    assert STATUS_CANARY not in DEGRADED_STATUSES


def test_health_and_metrics_text_agree_with_the_journal(scenarios):
    p = scenarios["port"]
    for moment, phase in (("canary", "canary"), ("end", "serving")):
        last = (p["journal_canary"] if moment == "canary" else p["journal"])[-1]
        h = p[f"health_{moment}"]
        g = _gauges(p[f"metrics_{moment}"])
        assert h["phase"] == last["state"] == phase and h["cycle"] == last["cycle"]
        assert g["cmlhn_lifecycle_cycle"] == float(last["cycle"])
        assert g[f'cmlhn_lifecycle_phase{{phase="{phase}"}}'] == 1.0
    assert p["health_end"]["active_version"] == 1 and p["health_end"]["canary"] is None


# ------------------------------------------------------------ chaos matrix
@pytest.mark.parametrize("site", KILL_SITES)
def test_kill_and_resume_promotes_the_same_artifact(tmp_path, baseline, reference_run, site):
    """A kill at each promotion-path site; the restarted loop reaches
    PROMOTED with the final artifact's arrays ``==`` the uninterrupted
    run's."""
    ctrl, crashes = _run("port", str(tmp_path), baseline, kill_site=site)
    assert crashes >= 1 and ctrl.active_version == 1 and ctrl.state == "serving"
    assert [e["state"] for e in ctrl.journal.entries()][-2:] == ["promoted", "serving"]
    got = _artifact_arrays(str(tmp_path), 1)
    assert sorted(got) == sorted(reference_run)
    for k, v in reference_run.items():
        assert got[k].tobytes() == v.tobytes(), k


class _Degraded:
    """Trains fine, then ships centers moved by 50 — the candidate the
    parity gate exists to refuse."""

    def __init__(self):
        self.inner = PL.KMeansRetrainer(FEATS, k=K, max_iter=30, tol=1e-4, device=CPU)

    def __call__(self, warm_model, table, ckpt_dir, seed):
        model, profile = self.inner(warm_model, table, ckpt_dir, seed)
        return port.KMeansModel(
            cluster_centers=np.asarray(model.cluster_centers) + 50.0,
            training_cost=model.training_cost, n_iter=model.n_iter,
            cluster_sizes=model.cluster_sizes), profile


def test_a_degraded_candidate_is_rolled_back_byte_for_byte(tmp_path, baseline):
    work = str(tmp_path)
    v0 = os.path.join(work, "lc", "models", "v0")
    srv, _, ctrl = _seed_world("port", work, baseline, _Degraded())
    before = _artifact_bytes(v0)
    with srv:
        _drive(srv, ctrl, _rolled_back)
    states = [e["state"] for e in ctrl.journal.entries()]
    assert "rolled_back" in states and "canary" not in states
    assert ctrl.active_version == 0
    rb = next(e for e in ctrl.journal.entries() if e["state"] == "rolled_back")
    assert "shadow parity" in rb["info"]["reason"]
    assert _artifact_bytes(v0) == before
    assert os.path.isdir(os.path.join(work, "lc", "models", "v1"))   # kept as evidence


def test_a_kill_at_rollback_resumes_to_the_prior_baseline(tmp_path, baseline):
    ctrl, crashes = _run("port", str(tmp_path), baseline, kill_site="lifecycle.rollback",
                         until=_rolled_back, retrainer=_Degraded(), make_retrainer=_Degraded)
    assert crashes >= 1 and ctrl.active_version == 0 and ctrl.state == "serving"


def test_recovery_is_idempotent_without_a_crash(tmp_path, baseline):
    _, pm, x0 = baseline
    srv, _, ctrl = _build("port", str(tmp_path))
    ctrl.bootstrap(pm, port.DataProfile.from_matrix(x0.astype(np.float64), FEATS), train_x=x0)
    n = len(ctrl.journal.entries())
    _, _, ctrl2 = _build("port", str(tmp_path))
    assert (ctrl2.state, ctrl2.active_version) == ("serving", 0)
    assert len(ctrl2.journal.entries()) == n
    assert ctrl2.baseline_metric == pytest.approx(ctrl.baseline_metric)


# ------------------------------------------------------------- the retrain
def test_the_retrain_out_of_core_matches_resident(tmp_path, baseline):
    """``out_of_core_rows`` fits through ``HostDataset`` blocks: the same
    n_iter, centers within OOC_TOL of the resident retrain."""
    _, pm, _ = baseline
    x = _blobs(np.random.default_rng(3), 3000, SHIFT)
    table = port.Table.from_dict({n: x[:, j] for j, n in enumerate(FEATS)})
    kw = dict(k=K, max_iter=30, tol=1e-4, device=CPU)
    res, prof = PL.KMeansRetrainer(FEATS, **kw)(pm, table, str(tmp_path / "a"), 5)
    ooc, _ = PL.KMeansRetrainer(FEATS, out_of_core_rows=512, **kw)(
        pm, table, str(tmp_path / "b"), 5)
    assert ooc.n_iter == res.n_iter
    assert np.abs(ooc.cluster_centers - res.cluster_centers).max() <= OOC_TOL
    assert prof.to_dict() == port.DataProfile.from_matrix(x, FEATS).to_dict()


def test_the_retrainer_needs_the_card_unless_asked(tmp_path, baseline, monkeypatch):
    _, pm, _ = baseline
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    table = port.Table.from_dict({n: np.ones(8) * j for j, n in enumerate(FEATS)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PL.KMeansRetrainer(FEATS, k=2)(pm, table, str(tmp_path / "c"), 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PL.LifecycleController(str(tmp_path / "lc"), port.serve.InferenceServer(), "m",
                               PL.KMeansRetrainer(FEATS))


# ---------------------------------------------------- host pieces vs JAX
def test_the_host_pieces_equal_the_reference(baseline):
    jm, pm, x0 = baseline
    rng = np.random.default_rng(2)
    rows = _blobs(rng, 256, 3.0)
    assert PL.kmeans_cost(pm, rows) == JL.kmeans_cost(jm, rows)
    sp, sj = PL.ShadowScorer(), JL.ShadowScorer()
    for _ in range(5):
        a, b = rng.integers(0, K, 16), rng.integers(0, K, 16)
        sp.observe(a, b)
        sj.observe(a, b)
    assert sp.snapshot() == sj.snapshot()
    for pmet, cmet in ((1.0, 1.04), (1.0, 1.2), (0.0, 1e-12), (1.0, float("nan"))):
        dp, dj = PL.ParityGate().decide(pmet, cmet), JL.ParityGate().decide(pmet, cmet)
        assert (dp.passed, dp.reasons) == (dj.passed, dj.reasons)
    for frac in (0.125, 0.25, 0.3, 1.0):
        rp, rj = PL.CanaryRouter(frac), JL.CanaryRouter(frac)
        assert [rp.take() for _ in range(50)] == [rj.take() for _ in range(50)]
        assert rp.snapshot() == rj.snapshot()
    with pytest.raises(ValueError, match="canary fraction"):
        PL.CanaryRouter(0.0)
    assert PL.STATES == JL.STATES and PL.feedback_schema(FEATS).names == list(
        JL.feedback_schema(FEATS).names)


# ------------------------------------------------- journal across packages
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_the_journal_crosses_the_packages_and_skips_a_bad_crc(tmp_path, writer):
    W, R = (PL, JL) if writer == "port" else (JL, PL)
    path = str(tmp_path / "journal.log")
    j = W.LifecycleJournal(path)
    j.append("serving", 0, {"active_version": 0, "baseline_metric": 0.25})
    j.append("drift_suspected", 0, {"reason": "psi", "max_psi": 3.5})
    j.append("retraining", 1, {"candidate_version": 1, "seed": 1})
    want = j.entries()
    assert R.LifecycleJournal(path).entries() == want
    with open(path, "rb") as f:
        lines = f.readlines()
    line = bytearray(lines[1])
    line[line.index(b"psi")] = ord(b"q")          # valid JSON, wrong CRC
    lines[1] = bytes(line)
    with open(path, "wb") as f:
        f.writelines(lines)
    for P in (PL, JL):
        r = P.LifecycleJournal(path)
        assert r.entries() == [want[0], want[2]] and r.corrupt_skipped == 1


def test_a_torn_journal_append_loses_only_the_tail(tmp_path):
    j = PL.LifecycleJournal(str(tmp_path / "journal.log"))
    j.append("serving", 0, {})
    plan = faults.FaultPlan().tear(
        "wal.append", at_byte=10,
        when=lambda ctx: str(ctx.get("path", "")).endswith("journal.log"))
    with faults.active(plan):
        with pytest.raises(faults.InjectedCrash):
            j.append("drift_suspected", 0, {})
    assert plan.fired("wal.append") == 1
    j2 = PL.LifecycleJournal(j.path)
    assert j2.last()["state"] == "serving"
    j2.append("drift_suspected", 0, {})
    assert JL.LifecycleJournal(j.path).last()["state"] == "drift_suspected"


# ------------------------------------------------ feedback across packages
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_the_feedback_wal_crosses_the_packages(tmp_path, writer):
    """A spool written by one package replays in the other to the same
    pending and joined state (a torn line skipped by both), and the
    other's flush writes the same CSV bytes the writer's would."""
    W, R = (PL, JL) if writer == "port" else (JL, PL)
    root, inc = str(tmp_path / "fb"), str(tmp_path / "in")
    buf = W.FeedbackBuffer(root, FEATS, inc)
    ids = [buf.record_prediction([float(i), 0.5, -1.0], float(i)) for i in range(6)]
    for i in ids[:4]:
        buf.record_outcome(i, 10.0 + i)
    assert buf.flush().endswith("feedback-000000.csv")
    buf.record_outcome(ids[4], 99.0)
    with open(os.path.join(root, "feedback.log"), "a") as f:
        f.write('{"kind": "pred", "id": 9, "x": [1.0, ')   # a torn tail
    rp, rw = R.FeedbackBuffer(root, FEATS, inc), W.FeedbackBuffer(root, FEATS, inc)
    for b in (rp, rw):
        assert (b.pending_outcomes(), b.joined_unflushed()) == (1, [ids[4]])
    p1 = rp.flush()
    with open(p1, "rb") as f:
        read_back = f.read()
    os.remove(p1)
    rw2 = W.FeedbackBuffer(str(tmp_path / "fb2"), FEATS, str(tmp_path / "in2"))
    fid = rw2.record_prediction([4.0, 0.5, -1.0], 4.0)
    rw2.record_outcome(fid, 99.0)
    with open(rw2.flush(), "rb") as f:
        assert f.read() == read_back


def test_a_feedback_flush_killed_between_intent_and_commit_never_flushes_twice(tmp_path):
    root, inc = str(tmp_path / "fb"), str(tmp_path / "in")
    buf = PL.FeedbackBuffer(root, FEATS, inc)
    for i in range(5):
        buf.record_outcome(buf.record_prediction([float(i), 2.0, 3.0], float(i)), i * 2.0)
    wal = os.path.join(root, "feedback.log")
    plan = faults.FaultPlan().crash("wal.append", after=1,   # the intent lands, the commit dies
                                    when=lambda ctx: str(ctx.get("path", "")) == wal)
    with faults.active(plan):
        with pytest.raises(faults.InjectedCrash):
            buf.flush()
    assert plan.fired("wal.append") == 1
    csv_path = os.path.join(inc, "feedback-000000.csv")
    with open(csv_path, "rb") as f:
        before = f.read()
    kinds = [json.loads(line)["kind"] for line in open(wal)]
    assert kinds.count("flush_intent") == 1 and "flush_commit" not in kinds
    buf2 = PL.FeedbackBuffer(root, FEATS, inc)
    assert buf2.flush() == csv_path
    with open(csv_path, "rb") as f:
        assert f.read() == before
    assert buf2.flush() is None and os.listdir(inc) == ["feedback-000000.csv"]
    # the JAX package's spool reads the healed WAL the same way
    assert JL.FeedbackBuffer(root, FEATS, inc).joined_unflushed() == []

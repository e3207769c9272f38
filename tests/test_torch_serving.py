"""A JAX-fitted KMeansModel, carried across with ``convert.py``, served by
the port's InferenceServer on the CPU.

Answers must EQUAL the JAX package's ``predict_numpy`` on the same rows:
the centers are the same float32 values and the blobs leave no near-tie
for float32 rounding to flip.
"""

import threading
import time

import numpy as np
import pytest
import torch

from clustermachinelearningforhospitalnetworks_apache_spark_tpu import KMeans as JaxKMeans
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.serve import (
    STATUS_DEADLINE_EXCEEDED,
    STATUS_OK,
    STATUS_REJECTED,
    STATUS_SHUTDOWN,
    STATUS_UNAVAILABLE,
    InferenceServer,
    MicroBatcher,
    ServingModel,
    ShardedScorer,
    bulk_score,
)

# the suite runs several worker processes on a few cores: one intra-op
# thread per worker keeps torch from oversubscribing them
torch.set_num_threads(1)

BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


@pytest.fixture(scope="module")
def fitted(mesh1):
    rng = np.random.default_rng(11)
    centers = rng.normal(0, 3, size=(8, 6))
    x = (centers[rng.integers(0, 8, 900)]
         + rng.normal(scale=0.3, size=(900, 6))).astype(np.float32)
    jm = JaxKMeans(k=8, seed=0).fit(x, mesh=mesh1)
    _, params, arrays = jm._artifacts()
    pm = port.kmeans_model_from_jax_arrays(**arrays, **params)
    return x, jm, pm


def test_convert_carries_every_parameter(fitted):
    _, jm, pm = fitted
    np.testing.assert_array_equal(pm.cluster_centers, np.asarray(jm.cluster_centers))
    np.testing.assert_array_equal(pm.cluster_sizes, np.asarray(jm.cluster_sizes))
    assert (pm.n_iter, pm.training_cost) == (jm.n_iter, jm.training_cost)
    assert pm.num_features == 6


def test_server_answers_mixed_sizes_like_jax(fitted):
    x, jm, pm = fitted
    want = np.asarray(jm.predict_numpy(x))
    sizes = [1, 7, 32, 200, 1, 256, 3, 64]
    with InferenceServer(device="cpu") as srv:
        srv.add_model("km", pm, buckets=BUCKETS)
        srv.start()
        s = 0
        for n in sizes:
            r = srv.predict("km", x[s : s + n])
            assert r.status == STATUS_OK and r.ok and not r.degraded
            np.testing.assert_array_equal(r.value, want[s : s + n])
            s += n
        stats = srv.stats()
    assert stats["recompiles"] == 0
    assert stats["warmup_compiles"] == len(BUCKETS)
    assert stats["statuses"] == {"ok": len(sizes)}
    assert stats["latency_p50_ms"] <= stats["latency_p99_ms"]


def test_concurrent_clients_all_answered(fitted):
    x, jm, pm = fitted
    want = np.asarray(jm.predict_numpy(x))
    results = {}
    with InferenceServer(device="cpu") as srv:
        srv.add_model("km", pm, buckets=BUCKETS)
        srv.start()

        def client(i):
            results[i] = srv.predict("km", x[i * 5 : i * 5 + 5])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    for i, r in results.items():
        assert r.status == STATUS_OK
        np.testing.assert_array_equal(r.value, want[i * 5 : i * 5 + 5])
    assert len(results) == 16


def test_saturated_queue_rejects_with_fallback(fitted):
    x, _, pm = fitted
    sm = ServingModel(pm, buckets=BUCKETS, device="cpu")
    b = MicroBatcher(sm, max_queue_rows=8, fallback=lambda rows: np.full(len(rows), -1))
    first = b.submit(x[:8])           # fills the bound exactly; no worker yet
    shed = b.submit(x[8:9]).wait(1.0)
    assert shed.status == STATUS_REJECTED and shed.degraded
    np.testing.assert_array_equal(shed.value, [-1])
    assert b.queue.depth_rows == 8
    b.start()
    assert first.wait(10.0).status == STATUS_OK
    b.stop()


def test_expired_deadline_and_shutdown(fitted):
    x, _, pm = fitted
    sm = ServingModel(pm, buckets=BUCKETS, device="cpu")
    b = MicroBatcher(sm)
    late = b.submit(x[:2], deadline_s=0.0)
    time.sleep(0.01)
    b.start()
    r = late.wait(10.0)
    assert r.status == STATUS_DEADLINE_EXCEEDED and not r.ok
    b.stop()
    # a stopped batcher answers queued and new requests "shutdown"
    b2 = MicroBatcher(sm)
    queued = b2.submit(x[:3])
    b2.stop()
    assert queued.wait(1.0).status == STATUS_SHUTDOWN
    assert b2.submit(x[:1]).wait(1.0).status == STATUS_SHUTDOWN
    with pytest.raises(ValueError, match="top bucket"):
        b2.submit(np.zeros((257, 6), np.float32))


def test_failing_model_answers_unavailable(fitted):
    x, _, pm = fitted

    class Broken(port.KMeansModel):
        def predict(self, xt):
            if xt.shape[0] > 1:   # warmup of the 1-row bucket passes
                raise RuntimeError("boom")
            return super().predict(xt)

    bad = Broken(pm.cluster_centers)
    sm = ServingModel(bad, buckets=(1, 4), device="cpu")
    with MicroBatcher(sm) as b:
        r = b.predict(x[:3])
    assert r.status == STATUS_UNAVAILABLE and r.value is None


def test_bulk_score_equals_predict(fitted):
    x, jm, pm = fitted
    want = np.asarray(jm.predict_numpy(x))
    np.testing.assert_array_equal(bulk_score(pm, x, device="cpu", chunk_rows=128), want)
    np.testing.assert_array_equal(bulk_score(pm, x, device="cpu"), want)
    scorer = ShardedScorer(pm, device="cpu", chunk_rows=256).warmup()
    np.testing.assert_array_equal(scorer.score(x), want)
    np.testing.assert_array_equal(scorer.score(x[:5]), want[:5])


# ------------------------------------------------------------ the front door
# One client, one request at a time, through both packages' servers: the
# input guards (impute and reject), a drift trip, hot swaps with and
# without a profile, and a failing primary.  Statuses, labels, details,
# ``health()`` and the ``stats()`` counters must be ``==``: the guards and
# monitors are host float64 numpy in both, and the blobs leave no near-tie
# for float32 rounding to flip.

_SERVER_KW = dict(breaker_failure_threshold=2, breaker_recovery_s=1000.0)
_DRIFT_KW = dict(drift_window_rows=32, drift_trip_after=2)
_NAMES = [f"f{j}" for j in range(6)]


def _fallback(rows):
    return np.full(len(rows), -1, dtype=np.int32)


def _schedule(x):
    """The request schedule: (step, model, rows) with planted bad rows, a
    shifted feed, and markers for the swaps and the failing primary."""
    rng = np.random.default_rng(21)
    steps = []
    for i in range(12):
        rows = x[rng.integers(0, len(x), int(rng.integers(1, 9)))].astype(np.float64)
        if i in (2, 4, 5, 8, 9):
            rows[0, i % 6] = (np.nan, np.inf, 1e6)[(i // 3) % 3]
        steps.append(("req", "km" if i % 4 else "kr", rows))
    shift = np.zeros(6)
    shift[2] = 40.0
    for i in range(10):                       # the drifting feed: trips km
        steps.append(("req", "km", x[rng.integers(0, len(x), 8)] + shift))
    steps.append(("swap_profile", "km", x + shift))
    for i in range(4):
        steps.append(("req", "km", x[rng.integers(0, len(x), 5)] + shift))
    steps.append(("swap_no_profile", "km", None))
    steps.append(("fail", "km", 2))
    for i in range(5):
        steps.append(("req", "km", x[rng.integers(0, len(x), 3)].astype(np.float64)))
    steps.append(("req", "kr", x[:4].astype(np.float64)))
    return steps


def _drive(pkg, fitted, tmp_path):
    import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu.utils import faults as JF
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.utils import (
        faults as PF,
    )

    x, jm, pm = fitted
    top, faults, model = (J, JF, jm) if pkg == "jax" else (port, PF, pm)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    profile = top.DataProfile.from_matrix(x.astype(np.float64), _NAMES)
    srv = top.serve.InferenceServer(**_SERVER_KW, **kw)
    srv.add_model("km", model, buckets=BUCKETS, fallback=_fallback,
                  data_profile=profile.to_dict(), input_policy="impute", **_DRIFT_KW)
    srv.add_model("kr", model, buckets=BUCKETS, data_profile=profile.to_dict(),
                  input_policy="reject", **_DRIFT_KW)
    out = []
    with srv:
        plan = None
        for kind, name, arg in _schedule(x):
            if kind == "req":
                r = srv.predict(name, arg)
                out.append((r.status, None if r.value is None else r.value.tolist(),
                            r.degraded, r.detail, srv.health()["status"]))
            elif kind == "swap_profile":
                srv.swap_model(name, model, data_profile=top.DataProfile.from_matrix(
                    arg.astype(np.float64), _NAMES))
            elif kind == "swap_no_profile":
                srv.swap_model(name, model)
            else:
                plan = faults.FaultPlan().fail("serve.predict", times=arg)
                faults.install(plan)
        faults.clear()
        health, stats = srv.health(), srv.stats()
        text = srv.metrics_text()
    for k in ("latency_p50_ms", "latency_p99_ms"):
        stats.pop(k)
    for m in stats["models"].values():
        m.pop("jit_cache_size")
    counters = sorted(line for line in text.splitlines()
                      if line.startswith(("cmlhn_serve_status", "cmlhn_serve_requests",
                                          "cmlhn_serve_breaker", "cmlhn_serve_inputs",
                                          "cmlhn_serve_drift", "cmlhn_serve_fallback")))
    return out, health, stats, counters


def test_front_door_schedule_answers_like_jax(fitted, tmp_path, monkeypatch):
    monkeypatch.setenv("CMLHN_FLIGHT_DIR", str(tmp_path / "flight"))
    got = _drive("port", fitted, tmp_path)
    want = _drive("jax", fitted, tmp_path)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]
    statuses = [a[0] for a in got[0]]
    assert {"ok", "invalid_input", "unavailable"} <= set(statuses)
    assert got[1]["drift_trips"] >= 1 and got[1]["inputs_imputed"] >= 1
    assert got[1]["breakers"]["km"]["opened_count"] >= 2 and got[1]["lifecycle"] is None


def test_health_and_metrics_text_of_a_stopped_and_an_empty_server():
    srv = port.serve.InferenceServer(device="cpu")
    h = srv.health()
    assert h["status"] == "stopped" and h["breakers"] == {} and h["quarantined_rows"] == 0
    assert "cmlhn_serve_requests" not in srv.metrics_text()
    srv.start()
    assert srv.health()["status"] == "ok"
    srv.stop()


def test_hot_swap_from_a_saved_artifact_loads_its_profile(fitted, tmp_path):
    x, jm, pm = fitted
    path = str(tmp_path / "km")
    pm.save(path)
    port.io.attach_data_profile(path, port.DataProfile.from_matrix(
        x.astype(np.float64) + 1.0, _NAMES).to_dict())
    with port.serve.InferenceServer(device="cpu") as srv:
        srv.add_model("km", path, buckets=BUCKETS, input_policy="impute")
        ref = srv._monitors["km"].reference
        assert ref.sketches["f0"].min == float(x[:, 0].min()) + 1.0
        prepared = srv.prepare_swap("km", path)
        assert prepared.profile is not None and prepared.family == "KMeansModel"
        sm = srv.commit_swap(prepared)
        assert srv.registry.get("km") is sm and srv._monitors["km"].rebases == 1
        r = srv.predict("km", x[:5])
        assert r.ok and np.array_equal(r.value, np.asarray(jm.predict_numpy(x[:5])))
        assert srv.stats()["models"]["km"]["breaker"] == "closed"


def test_guard_counters_are_exact_under_concurrent_clients(fitted):
    """The input guard runs on each client's own thread: every counter it
    moves goes through ``ServingMetrics``' lock, so none is lost when
    clients race, and the counts equal the planted cells."""
    x, jm, pm = fitted
    profile = port.DataProfile.from_matrix(x.astype(np.float64), _NAMES)
    srv = port.serve.InferenceServer(device="cpu", **_SERVER_KW)
    srv.add_model("km", pm, buckets=BUCKETS, fallback=_fallback,
                  data_profile=profile.to_dict(), input_policy="impute",
                  drift_window_rows=16, drift_trip_after=2)
    srv.add_model("kr", pm, buckets=BUCKETS, data_profile=profile.to_dict(),
                  input_policy="reject")
    guard_keys = ("serve.inputs_imputed", "serve.inputs_rejected", "serve.drift_trips")
    unlocked = []
    inc = srv.metrics.registry.inc

    def checked_inc(name, value=1.0):
        if name in guard_keys and not srv.metrics._lock.locked():
            unlocked.append(name)
        inc(name, value)

    srv.metrics.registry.inc = checked_inc
    rng = np.random.default_rng(5)
    plans = []
    for i in range(64):
        rows = x[rng.integers(0, len(x), int(rng.integers(1, 9)))].astype(np.float64)
        n_bad = int(rng.integers(0, 3))
        for j in rng.choice(rows.size, n_bad, replace=False):
            rows.flat[j] = (np.nan, np.inf, 1e6)[j % 3]
        plans.append(("km" if i % 2 else "kr", rows, n_bad))
    shifted = x[:8].astype(np.float64) + [0.0, 0.0, 40.0, 0.0, 0.0, 0.0]
    answers = [None] * len(plans)

    def client(c):
        for i in range(c, len(plans), 8):
            answers[i] = srv.predict(plans[i][0], plans[i][1]).status

    with srv:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        counters = dict(srv.metrics.registry.counters)
        for _ in range(8):                 # shifted past the profile: trips km
            srv.predict("km", shifted)
    assert srv.metrics.registry.counters.get("serve.drift_trips", 0) >= 1
    assert unlocked == []
    assert counters["serve.inputs_imputed"] == sum(n for m, _, n in plans if m == "km")
    n_rejected = sum(1 for m, _, n in plans if m == "kr" and n)
    assert counters["serve.inputs_rejected"] == n_rejected
    assert [s for (m, _, n), s in zip(plans, answers) if m == "kr" and n] == (
        ["invalid_input"] * n_rejected)

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

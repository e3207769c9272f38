"""The port's StreamingKMeans against the JAX package's, on the CPU.

The same numpy-seeded micro-batches go through the JAX ``StreamingKMeans``
on a one-device mesh and the port's (``device="cpu"``: K1's plain
version for the batch statistics).

Tolerances, and why:
- the lazy init (k-means++ and ten host Lloyd steps on the first batch's
  sample) is bit-equal: the same numpy code on the same rows;
- centers at rtol 1e-5, atol 1e-5: the per-cluster sums are float32 sums
  in another order (XLA's one-hot product against K1's plain
  ``index_add_``), and the decayed merge carries that rounding on;
- weights at rtol 1e-6: counts of unit weights are exact in float32 in
  any order; only the decay's float32 products round;
- a reseeded center within 1e-5: its jitter is ``prng.normal``, at most
  3 float32 ulp from ``jax.random.normal``, times a 1e-4 scale.
"""

import numpy as np
import pytest
import torch

from clustermachinelearningforhospitalnetworks_apache_spark_tpu import (
    load_model as jax_load_model,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.models.streaming_kmeans import (
    StreamingKMeans as JaxStreamingKMeans,
)
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models.streaming_kmeans import (
    StreamingKMeans,
)

torch.set_num_threads(1)

K, D = 4, 3


def _batches(sizes, seed=0, shift=0.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 4, size=(K, D))
    out = []
    for n in sizes:
        x = centers[rng.integers(0, K, n)] + rng.normal(scale=0.4, size=(n, D)) + shift
        out.append(x.astype(np.float32))
    return out


def _assert_state_match(sk_port, sk_jax):
    pm, jm = sk_port.latest_model, sk_jax.latest_model
    assert pm.n_iter == jm.n_iter
    np.testing.assert_allclose(pm.cluster_centers, np.asarray(jm.cluster_centers),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pm.cluster_weights, np.asarray(jm.cluster_weights),
                               rtol=1e-6)
    return pm, jm


@pytest.mark.parametrize("rule", [
    dict(decay_factor=1.0),
    dict(decay_factor=0.6),
    dict(half_life=2.0, time_unit="batches"),
    dict(half_life=150.0, time_unit="points"),
])
def test_update_matches_jax(rule, mesh1):
    batches = _batches([200, 200, 150, 220, 200])
    sj = JaxStreamingKMeans(k=K, seed=3, **rule)
    sp = StreamingKMeans(k=K, seed=3, **rule)
    for i, b in enumerate(batches):
        sj.update(b, mesh=mesh1)
        sp.update(b, device="cpu")
        if i == 0:
            # the lazy init is bit-equal; one update has run on top of it
            assert sp._steps == 1
    pm, jm = _assert_state_match(sp, sj)
    x = np.concatenate(batches)
    np.testing.assert_array_equal(pm.predict_numpy(x, device="cpu"),
                                  np.asarray(jm.predict_numpy(x)))


def test_lazy_init_is_bit_equal(mesh1):
    b = _batches([300])[0]
    sj = JaxStreamingKMeans(k=K, seed=5)
    sp = StreamingKMeans(k=K, seed=5)
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu.parallel.sharding import (
        device_dataset,
    )
    sj._ensure_centers(device_dataset(b, None, mesh=mesh1))
    sp._ensure_centers(port.device_dataset(b, device="cpu"))
    np.testing.assert_array_equal(sp._centers.numpy(), np.asarray(sj._centers))


def test_update_many_matches_jax_and_update(mesh1):
    # ragged batches, the first one initializing the centers
    batches = _batches([120, 200, 90, 200, 160], seed=1)
    sj = JaxStreamingKMeans(k=K, seed=0, half_life=3.0)
    sp = StreamingKMeans(k=K, seed=0, half_life=3.0)
    sj.update_many(batches, mesh=mesh1)
    sp.update_many(batches, device="cpu")
    _assert_state_match(sp, sj)
    # update_many is update's rule batch by batch: bit-identical in the port
    one = StreamingKMeans(k=K, seed=0, half_life=3.0)
    for b in batches:
        one.update(b, device="cpu")
    assert torch.equal(one._centers, sp._centers)
    assert torch.equal(one._weights, sp._weights)
    assert torch.equal(one._weights_lo, sp._weights_lo)


def test_dying_cluster_is_reseeded_like_jax(mesh1):
    batches = _batches([200, 200, 200], seed=2)
    rng = np.random.default_rng(0)
    init = rng.normal(0, 4, size=(K, D)).astype(np.float32)
    init[2] = 1e3                       # attracts no row: weight 0, dead at once
    sj = JaxStreamingKMeans(k=K, seed=7, decay_factor=0.5).set_initial_centers(init)
    sp = StreamingKMeans(k=K, seed=7, decay_factor=0.5).set_initial_centers(init)
    sj.update(batches[0], mesh=mesh1)
    sp.update(batches[0], device="cpu")
    pm, jm = _assert_state_match(sp, sj)
    # the dead center moved next to the heaviest one and took half its weight
    assert np.abs(pm.cluster_centers[2]).max() < 100
    assert pm.cluster_weights[2] > 0
    assert np.count_nonzero(pm.cluster_weights == pm.cluster_weights[2]) >= 2
    for b in batches[1:]:
        sj.update(b, mesh=mesh1)
        sp.update(b, device="cpu")
    _assert_state_match(sp, sj)


def test_time_unit_is_checked():
    sp = StreamingKMeans(k=2, half_life=1.0, time_unit="days")
    with pytest.raises(ValueError, match="time_unit"):
        sp.update(np.zeros((4, 2), np.float32), device="cpu")
    with pytest.raises(ValueError, match="no centers"):
        StreamingKMeans(k=2).latest_model


def test_artifacts_cross_packages(tmp_path, mesh1):
    batches = _batches([200, 200], seed=4)
    sj = JaxStreamingKMeans(k=K, seed=1)
    sp = StreamingKMeans(k=K, seed=1)
    for b in batches:
        sj.update(b, mesh=mesh1)
        sp.update(b, device="cpu")
    x = np.concatenate(batches)
    jm, pm = sj.latest_model, sp.latest_model
    jm.save(str(tmp_path / "jax"))
    pm.save(str(tmp_path / "port"))
    from_jax = port.load_model(str(tmp_path / "jax"))
    from_port = jax_load_model(str(tmp_path / "port"))
    assert type(from_jax).__name__ == type(from_port).__name__ == "StreamingKMeansModel"
    np.testing.assert_array_equal(from_jax.cluster_centers, np.asarray(jm.cluster_centers))
    np.testing.assert_array_equal(from_jax.cluster_weights, np.asarray(jm.cluster_weights))
    np.testing.assert_array_equal(from_jax.predict_numpy(x, device="cpu"),
                                  np.asarray(jm.predict_numpy(x)))
    np.testing.assert_array_equal(np.asarray(from_port.predict_numpy(x)),
                                  pm.predict_numpy(x, device="cpu"))
    carried = port.streaming_kmeans_model_from_jax_arrays(
        **{k: v for k, v in jm._artifacts()[2].items()}, **jm._artifacts()[1])
    np.testing.assert_array_equal(carried.cluster_weights, np.asarray(jm.cluster_weights))
    np.testing.assert_array_equal(carried.predict_numpy(x, device="cpu"),
                                  np.asarray(jm.predict_numpy(x)))

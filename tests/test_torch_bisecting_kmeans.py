"""The port's BisectingKMeans against the JAX package's, on the CPU.

Blobs (n=2,000, d=3, 6 true clusters, offset by +20 so the recentering
matters) go through the JAX ``BisectingKMeans`` on its 8-device CPU mesh
and the port's (``device="cpu"``), for both strategies, one and four
restarts, and ``min_divisible_cluster_size`` given as rows and as a
fraction.

Tolerances, and why:
- sizes, the number of splits and predictions equal: the children's
  seeds differ by at most a few float32 ulp (``prng.normal`` against
  ``jax.random.normal``), which moves no row of these blobs to the other
  child;
- with several restarts, the same leaves in any order: two restarts can
  grow the same partition with its leaves numbered differently, at costs
  equal up to float32 rounding, so which of them wins is a near tie that
  the summation order decides;
- centers at atol 1e-4 and the training cost at rtol 1e-5: float32 sums
  over rows, reduced per device and psummed by the JAX package and in one
  order by the port.
"""

import numpy as np
import pytest
import torch

from clustermachinelearningforhospitalnetworks_apache_spark_tpu import (
    BisectingKMeans as JaxBisecting,
    load_model as jax_load_model,
)
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port

torch.set_num_threads(1)


def _blobs(n=2000, d=3, k=6, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 6, (k, d))
    return (c[rng.integers(0, k, n)] + rng.normal(scale=0.7, size=(n, d)) + 20.0).astype(
        np.float32)


def _leaf_order(centers):
    c = np.asarray(centers)
    return np.lexsort(c.T[::-1])


def _assert_match(pm, jm, x=None, any_order=False):
    """The models' leaves equal (in order, or sorted by center when
    ``any_order``), and their predictions on ``x`` under that matching."""
    po = _leaf_order(pm.cluster_centers) if any_order else np.arange(len(pm.cluster_centers))
    jo = _leaf_order(jm.cluster_centers) if any_order else np.arange(len(jm.cluster_centers))
    np.testing.assert_array_equal(pm.cluster_sizes[po], np.asarray(jm.cluster_sizes)[jo])
    assert pm.n_iter == jm.n_iter
    np.testing.assert_allclose(pm.cluster_centers[po], np.asarray(jm.cluster_centers)[jo],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(pm.training_cost, jm.training_cost, rtol=1e-5)
    if x is not None:
        to_jax = np.empty(len(po), np.int64)
        to_jax[po] = jo
        np.testing.assert_array_equal(to_jax[pm.predict_numpy(x, device="cpu")],
                                      np.asarray(jm.predict_numpy(x)))


@pytest.mark.parametrize("strategy", ["level", "sequential"])
@pytest.mark.parametrize("n_restarts", [1, 4])
@pytest.mark.parametrize("min_div", [1.0, 150.0, 0.2])
def test_fit_matches_jax(strategy, n_restarts, min_div):
    x = _blobs()
    kw = dict(k=5, seed=1, strategy=strategy, n_restarts=n_restarts,
              min_divisible_cluster_size=min_div)
    jm = JaxBisecting(**kw).fit(x)
    pm = port.BisectingKMeans(**kw).fit(x, device="cpu")
    _assert_match(pm, jm, x, any_order=n_restarts > 1)
    info = pm.fit_info
    assert info["trees"] == n_restarts and len(info["levels"]) >= 1
    assert info["host_syncs"] == 1 + info["lloyd_iters"] + len(info["levels"])


def test_min_divisible_size_stops_splitting():
    # a leaf must hold 45 % of the rows to split: fewer than k leaves grow
    x = _blobs(seed=3)
    kw = dict(k=8, seed=0, n_restarts=1, min_divisible_cluster_size=0.45)
    jm = JaxBisecting(**kw).fit(x)
    pm = port.BisectingKMeans(**kw).fit(x, device="cpu")
    assert pm.cluster_centers.shape[0] < 8
    _assert_match(pm, jm, x)


def test_more_leaves_than_clusters_compacts_empty_leaves():
    # 40 rows on 3 distinct points: splits of duplicate points fail and
    # leave empty leaves, compacted away in both packages
    pts = np.repeat(np.array([[0, 0], [5, 5], [9, 0]], np.float32), [15, 15, 10], axis=0)
    jm = JaxBisecting(k=6, seed=0, n_restarts=1).fit(pts)
    pm = port.BisectingKMeans(k=6, seed=0, n_restarts=1).fit(pts, device="cpu")
    _assert_match(pm, jm)
    assert pm.cluster_centers.shape[0] <= 3


def test_cross_package_load(tmp_path):
    x = _blobs(seed=2)
    jm = JaxBisecting(k=4, seed=0).fit(x)
    pm = port.BisectingKMeans(k=4, seed=0).fit(x, device="cpu")
    jm.save(str(tmp_path / "jax"))
    pm.save(str(tmp_path / "port"))
    from_jax = port.load_model(str(tmp_path / "jax"))
    from_port = jax_load_model(str(tmp_path / "port"))
    assert type(from_jax).__name__ == type(from_port).__name__ == "BisectingKMeansModel"
    np.testing.assert_array_equal(from_jax.cluster_centers, np.asarray(jm.cluster_centers))
    np.testing.assert_array_equal(from_jax.predict_numpy(x, device="cpu"),
                                  np.asarray(jm.predict_numpy(x)))
    np.testing.assert_array_equal(np.asarray(from_port.predict_numpy(x)),
                                  pm.predict_numpy(x, device="cpu"))
    carried = port.bisecting_kmeans_model_from_jax_arrays(
        **jm._artifacts()[2], **jm._artifacts()[1])
    np.testing.assert_array_equal(carried.cluster_sizes, np.asarray(jm.cluster_sizes))
    np.testing.assert_array_equal(carried.predict_numpy(x, device="cpu"),
                                  np.asarray(jm.predict_numpy(x)))


@pytest.mark.parametrize("kw, err", [
    (dict(distance_measure="cosine"), NotImplementedError),
    (dict(weight_col="w"), NotImplementedError),
    (dict(strategy="greedy"), ValueError),
    (dict(n_restarts=0), ValueError),
])
def test_unported_and_bad_options_raise(kw, err):
    with pytest.raises(err):
        port.BisectingKMeans(k=2, **kw).fit(_blobs(20), device="cpu")


def test_empty_fit_raises():
    with pytest.raises(ValueError, match="empty"):
        port.BisectingKMeans(k=2).fit((_blobs(8), np.zeros(8), np.zeros(8)), device="cpu")

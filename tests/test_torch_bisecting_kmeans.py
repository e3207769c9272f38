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
        kw = {"device": "cpu"} if isinstance(jm, port.KMeansModel) else {}
        np.testing.assert_array_equal(to_jax[pm.predict_numpy(x, device="cpu")],
                                      np.asarray(jm.predict_numpy(x, **kw)))


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


@pytest.mark.parametrize("strategy", ["level", "sequential"])
def test_split_log_records_the_tree(strategy):
    # [level, parent slot, new slot]: slots are handed out in order, a
    # parent exists before its child, one entry a successful split
    x = _blobs()
    pm = port.BisectingKMeans(k=5, seed=1, strategy=strategy, n_restarts=1).fit(
        x, device="cpu")
    splits = pm.fit_info["splits"]
    assert len(splits) == pm.n_iter == 4
    assert [c for _, _, c in splits] == [1, 2, 3, 4]
    assert all(p < c for _, p, c in splits)
    levels = [lv for lv, _, _ in splits]
    assert levels == sorted(levels)
    if strategy == "sequential":
        assert levels == list(range(4))


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
    # cosine and weight_col came with slice 4c (the tests below); a weight
    # column needs a table input, as in the reference
    (dict(distance_measure="cosine"), None),
    (dict(weight_col="w"), ValueError),
    (dict(strategy="greedy"), ValueError),
    (dict(n_restarts=0), ValueError),
])
def test_unported_and_bad_options_raise(kw, err):
    if err is None:
        m = port.BisectingKMeans(k=2, **kw).fit(_blobs(20), device="cpu")
        assert m.cluster_centers.shape[0] == 2
        return
    with pytest.raises(err):
        port.BisectingKMeans(k=2, **kw).fit(_blobs(20), device="cpu")
    if kw.get("weight_col") is None:
        with pytest.raises(err):
            port.BisectingKMeans(k=2, **kw).fit(port.HostDataset(x=_blobs(20)),
                                               device="cpu")


def test_empty_fit_raises():
    with pytest.raises(ValueError, match="empty"):
        port.BisectingKMeans(k=2).fit((_blobs(8), np.zeros(8), np.zeros(8)), device="cpu")


# --------------------------------------------- slice 4c: cosine, weights,
# out of core.  Tolerances as above; out of core against resident the
# centers at atol 1e-4 too (the blocks' float32 sums against one pass).

def _cosine_blobs(n=2000, d=3, k=6, seed=0):
    """Directions that cluster by angle (radii spread over 1..5)."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(k, d))
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    u = c[rng.integers(0, k, n)] + rng.normal(scale=0.08, size=(n, d))
    return (u * rng.uniform(1, 5, (n, 1))).astype(np.float32)


@pytest.mark.parametrize("strategy", ["level", "sequential"])
def test_cosine_matches_jax(strategy):
    x = _cosine_blobs()
    kw = dict(k=5, seed=1, strategy=strategy, n_restarts=1, distance_measure="cosine")
    jm = JaxBisecting(**kw).fit(x)
    pm = port.BisectingKMeans(**kw).fit(x, device="cpu")
    assert pm.distance_measure == "cosine"
    np.testing.assert_allclose(np.linalg.norm(pm.cluster_centers, axis=1), 1.0, atol=1e-5)
    _assert_match(pm, jm, x)


def _weighted_table(x, w):
    cols = {f"f{j}": x[:, j] for j in range(x.shape[1])}
    cols["w"] = w
    return cols


@pytest.mark.parametrize("min_div", [1.0, 0.2])
def test_weighted_matches_jax(min_div):
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu import (
        Table as JTable, VectorAssembler as JAssembler,
    )

    x = _blobs(seed=5)
    w = np.random.default_rng(6).integers(0, 4, len(x)).astype(np.float64)
    cols = _weighted_table(x, w)
    names = [f"f{j}" for j in range(3)]
    kw = dict(k=5, seed=1, n_restarts=1, weight_col="w", min_divisible_cluster_size=min_div)
    jm = JaxBisecting(**kw).fit(JAssembler(names).transform(JTable.from_dict(cols)))
    pm = port.BisectingKMeans(**kw).fit(
        port.VectorAssembler(names).transform(port.Table.from_dict(cols)), device="cpu")
    _assert_match(pm, jm, x)
    assert float(pm.cluster_sizes.sum()) == float(w.sum())
    # the weights act: the unweighted fit differs
    un = port.BisectingKMeans(k=5, seed=1, n_restarts=1).fit(x, device="cpu")
    assert not np.allclose(np.sort(un.cluster_sizes), np.sort(pm.cluster_sizes))


@pytest.mark.parametrize("kw", [
    dict(k=5, seed=1, n_restarts=1),
    dict(k=4, seed=2, n_restarts=3, strategy="sequential"),
    dict(k=5, seed=1, n_restarts=1, distance_measure="cosine"),
    dict(k=6, seed=0, n_restarts=1, min_divisible_cluster_size=0.2),
])
def test_outofcore_matches_resident_and_jax(kw):
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu.parallel.outofcore import (
        HostDataset as JHostDataset,
    )

    x = _cosine_blobs() if kw.get("distance_measure") == "cosine" else _blobs()
    res = port.BisectingKMeans(**kw).fit(x, device="cpu")
    ooc = port.BisectingKMeans(**kw).fit(port.HostDataset(x=x, max_device_rows=512),
                                         device="cpu")
    jooc = JaxBisecting(**kw).fit(JHostDataset(x=x, max_device_rows=512))
    many = kw["n_restarts"] > 1
    _assert_match(ooc, res, x, any_order=many)
    _assert_match(ooc, jooc, x, any_order=many)
    info = ooc.fit_info
    assert info["host_syncs"] == 2 + info["lloyd_iters"] + len(info["levels"]) * (4 + 1)
    if not many:
        assert info["splits"] == res.fit_info["splits"]


def test_outofcore_weighted_and_empty():
    x = _blobs(n=1024, seed=7)
    w = np.random.default_rng(8).integers(0, 3, len(x)).astype(np.float32)
    kw = dict(k=4, seed=0, n_restarts=1)
    res = port.BisectingKMeans(**kw).fit((x, np.zeros(len(x)), w), device="cpu")
    ooc = port.BisectingKMeans(**kw).fit(port.HostDataset(x=x, w=w, max_device_rows=256),
                                         device="cpu")
    _assert_match(ooc, res, x)
    with pytest.raises(ValueError, match="empty"):
        port.BisectingKMeans(**kw).fit(port.HostDataset(x=x, w=np.zeros(len(x))),
                                       device="cpu")
    with pytest.raises(ValueError, match="empty"):
        port.BisectingKMeans(**kw).fit(port.HostDataset(x=x[:0]), device="cpu")


def test_block_moments_matches_jax():
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu.parallel.outofcore import (
        block_moments as jax_block_moments,
    )
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.parallel import (
        block_moments,
    )

    rng = np.random.default_rng(9)
    x = rng.normal(size=(64, 3)).astype(np.float32)
    x[5] = np.nan                      # a pad row: masked before any product
    y = rng.normal(size=64).astype(np.float32)
    w = rng.uniform(0, 2, 64).astype(np.float32)
    w[5] = 0.0
    for extra in ("none", "ysum", "ymax"):
        got = block_moments(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w),
                            extra)
        want = jax_block_moments(x, y, w, extra=extra)
        assert len(got) == len(want)
        for g, j in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-6)

"""The port's KMeans slice against the JAX package, on the CPU.

Same numpy-seeded blobs into both: the JAX ``KMeans`` on a one-device
mesh (its XLA scan path and its Pallas path in interpret mode) and the
port's ``KMeans(..., device="cpu")``, whose Lloyd steps run the plain
version of the K1 kernel.

Tolerances, and why:
- init centers bit-equal: the same host k-means++ on the same float32
  rows from the same ``default_rng(seed)`` draws;
- ``n_iter``, ``cluster_sizes`` and predictions equal: well-separated
  blobs leave no near-tie for float32 rounding to flip;
- centers and ``training_cost`` at rtol 1e-5 (centers with atol 1e-5 ×
  the data's scale, for coordinates near 0): float32 sums in another
  order;
- silhouette within 1e-5: the same O(n·k) formula, summed in another
  order;
- assembler → scaler matrices at rtol 1e-5: one-pass float32 moments,
  summed in another order.
"""

import numpy as np
import pytest
import torch

from clustermachinelearningforhospitalnetworks_apache_spark_tpu import (
    ClusteringEvaluator as JaxEvaluator,
    KMeans as JaxKMeans,
    StandardScaler as JaxScaler,
    Table as JaxTable,
    VectorAssembler as JaxAssembler,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.parallel.sharding import (
    device_dataset as jax_device_dataset,
)
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.data import (
    device_dataset as port_device_dataset,
)

# the suite runs several worker processes on a few cores: one intra-op
# thread per worker keeps torch from oversubscribing them
torch.set_num_threads(1)

FEATS = [f"f{i}" for i in range(5)]


def _blobs(n=640, d=5, k=8, seed=0, spread=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 3, size=(k, d))
    x = centers[rng.integers(0, k, n)] + rng.normal(scale=spread, size=(n, d))
    return x.astype(np.float32)


def _assert_models_match(pm, jm, scale):
    assert pm.n_iter == jm.n_iter
    np.testing.assert_array_equal(pm.cluster_sizes, np.asarray(jm.cluster_sizes))
    np.testing.assert_allclose(pm.cluster_centers, np.asarray(jm.cluster_centers),
                               rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(pm.training_cost, jm.training_cost, rtol=1e-5)


@pytest.mark.parametrize("init_mode", ["k-means++", "random"])
@pytest.mark.parametrize("init_sample_size", [65536, 64])
def test_init_centers_bit_equal(init_sample_size, init_mode, mesh1):
    x = _blobs()
    jest = JaxKMeans(k=8, seed=0, init_sample_size=init_sample_size,
                     init_mode=init_mode)
    pest = port.KMeans(k=8, seed=0, init_sample_size=init_sample_size,
                       init_mode=init_mode)
    j_init = jest._init_centers(jax_device_dataset(x, mesh=mesh1), mesh1)
    p_init = pest._init_centers(port_device_dataset(x, device="cpu"))
    assert p_init.dtype == np.float64
    np.testing.assert_array_equal(p_init, j_init)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("init_sample_size", [65536, 64])
def test_fit_matches_jax(use_pallas, init_sample_size, mesh1):
    x = _blobs()
    jm = JaxKMeans(k=8, seed=0, use_pallas=use_pallas,
                   init_sample_size=init_sample_size).fit(x, mesh=mesh1)
    pm = port.KMeans(k=8, seed=0, init_sample_size=init_sample_size).fit(
        x, device="cpu"
    )
    _assert_models_match(pm, jm, float(np.abs(x).max()))
    assert pm.summary.num_iter == jm.summary.num_iter
    assert pm.summary.k == 8


def test_fit_stops_at_max_iter_like_jax(mesh1):
    """Overlapping blobs and tol=0 run the whole step budget: the step
    count follows the reference loop exactly."""
    x = _blobs(spread=2.5, seed=4)
    jm = JaxKMeans(k=8, seed=0, max_iter=3, tol=0.0).fit(x, mesh=mesh1)
    pm = port.KMeans(k=8, seed=0, max_iter=3, tol=0.0).fit(x, device="cpu")
    assert pm.n_iter == jm.n_iter == 3
    _assert_models_match(pm, jm, float(np.abs(x).max()))


def test_predict_and_silhouette_match_jax(mesh1):
    x = _blobs(seed=2)
    jm = JaxKMeans(k=8, seed=0).fit(x, mesh=mesh1)
    pm = port.KMeans(k=8, seed=0).fit(x, device="cpu")
    j_pred = np.asarray(jm.predict_numpy(x))
    p_pred = pm.predict_numpy(x, device="cpu")
    np.testing.assert_array_equal(p_pred, j_pred)
    p_sil = port.ClusteringEvaluator().evaluate(x, p_pred, k=8, device="cpu")
    j_sil = JaxEvaluator().evaluate(x, j_pred, k=8, mesh=mesh1)
    assert abs(p_sil - j_sil) <= 1e-5
    assert 0.0 < p_sil <= 1.0
    # device-resident form: the dataset plus the tensor predict returns
    ds = port_device_dataset(x, device="cpu")
    assert abs(port.ClusteringEvaluator().evaluate(ds, pm.predict(ds.x)) - p_sil) <= 1e-6
    np.testing.assert_allclose(pm.compute_cost(x, device="cpu"),
                               jm.compute_cost(x, mesh=mesh1), rtol=1e-5)


def _hospital_like_table(n=517, seed=5):
    x = _blobs(n=n, seed=seed, spread=1.0).astype(np.float64) * [1, 10, 100, 0.1, 1]
    return {name: x[:, i] for i, name in enumerate(FEATS)}


def test_assembler_scaler_match_jax():
    cols = _hospital_like_table()
    jt = JaxAssembler(FEATS).transform(JaxTable.from_dict(cols))
    pt = port.VectorAssembler(FEATS).transform(port.Table.from_dict(cols))
    np.testing.assert_array_equal(pt.features, jt.features)
    # device route: one-pass float32 moments on the device
    p_ds = port.StandardScaler().fit_transform(pt, device="cpu")
    j_ds = JaxScaler().fit_transform(jt)
    n = len(pt)
    np.testing.assert_allclose(p_ds.x.numpy()[:n], np.asarray(j_ds.x)[:n],
                               rtol=1e-5, atol=1e-5)
    p_model = port.StandardScaler().fit(pt, device="cpu")
    j_model = JaxScaler().fit(jt)
    np.testing.assert_allclose(p_model.mean, np.asarray(j_model.mean), rtol=1e-5)
    np.testing.assert_allclose(p_model.std, np.asarray(j_model.std), rtol=1e-5)
    # host route: the same moments applied to the float64 matrix
    carried = port.scaler_model_from_jax_arrays(
        np.asarray(j_model.mean), np.asarray(j_model.std)
    )
    np.testing.assert_array_equal(carried.transform(pt).features,
                                  j_model.transform(jt).features)


def test_scaler_matrix_route_matches_jax_host_route():
    """An ndarray is fit in float64 (population std) on the named device,
    as the JAX package fits it on the host: moments within float64
    rounding (rtol 1e-12, another summation order), the scaled matrix a
    float64 ndarray at the same tolerance."""
    x = _hospital_like_table(n=333, seed=11)
    x = np.stack([x[f] for f in FEATS], axis=1)
    j_model = JaxScaler().fit(x)
    p_model = port.StandardScaler().fit(x, device="cpu")
    np.testing.assert_allclose(p_model.mean, j_model.mean, rtol=1e-12)
    np.testing.assert_allclose(p_model.std, j_model.std, rtol=1e-12)
    p_out = port.StandardScaler().fit_transform(x, device="cpu")
    assert isinstance(p_out, np.ndarray) and p_out.dtype == np.float64
    np.testing.assert_allclose(p_out, JaxScaler().fit_transform(x), rtol=1e-12,
                               atol=1e-12)
    t_out = port.StandardScaler().fit_transform(torch.from_numpy(x), device="cpu")
    np.testing.assert_array_equal(t_out.numpy(), p_out)


def test_scaler_leaves_constant_columns_and_rezeroes_pad_rows():
    x = np.c_[np.arange(6.0), np.full(6, 3.0)]
    ds = port_device_dataset(x, device="cpu", weights=[1, 1, 1, 1, 0, 0])
    model = port.StandardScaler().fit(ds)
    assert model.std[1] == 0.0
    out = model.transform(ds)
    assert torch.all(out.x[4:] == 0)
    np.testing.assert_allclose(out.x[:4, 1].numpy(), 0.0)


def test_whole_slice_table_to_silhouette(mesh1):
    """Table → VectorAssembler → StandardScaler → KMeans → predict →
    silhouette, through both packages."""
    cols = _hospital_like_table(n=700, seed=9)
    jt = JaxAssembler(FEATS).transform(JaxTable.from_dict(cols))
    j_ds = JaxScaler().fit_transform(jt)
    jx = np.asarray(j_ds.x)[: len(jt)]
    jm = JaxKMeans(k=8, seed=0).fit(jx, mesh=mesh1)
    j_pred = np.asarray(jm.predict_numpy(jx))
    j_sil = JaxEvaluator().evaluate(jx, j_pred, k=8, mesh=mesh1)

    pt = port.VectorAssembler(FEATS).transform(port.Table.from_dict(cols))
    p_ds = port.StandardScaler().fit_transform(pt, device="cpu")
    pm = port.KMeans(k=8, seed=0).fit(p_ds)
    p_pred = pm.predict(p_ds.x)
    p_sil = port.ClusteringEvaluator().evaluate(p_ds, p_pred, k=8)

    assert pm.n_iter == jm.n_iter
    np.testing.assert_array_equal(p_pred.numpy(), j_pred)
    np.testing.assert_array_equal(pm.cluster_sizes, np.asarray(jm.cluster_sizes))
    np.testing.assert_allclose(pm.training_cost, jm.training_cost, rtol=1e-5)
    assert abs(p_sil - j_sil) <= 1e-5 and 0.0 < p_sil <= 1.0


def test_fit_refuses_empty_and_cosine():
    # cosine came with slice 4b (tests/test_torch_outofcore.py); a measure
    # neither package knows is refused
    with pytest.raises(ValueError, match="empty"):
        port.KMeans(k=2).fit(np.zeros((0, 3), np.float32), device="cpu")
    with pytest.raises(ValueError, match="euclidean"):
        port.KMeansModel(np.zeros((2, 3), np.float32), distance_measure="manhattan")
    assert port.KMeansModel(np.zeros((2, 3), np.float32),
                            distance_measure="cosine").distance_measure == "cosine"

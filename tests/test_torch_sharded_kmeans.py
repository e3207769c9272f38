"""KMeans over a (data, model) mesh: the port's sharded fit, predict, cost
and silhouette against its own single-device path and against the JAX
package's fit on the same mesh shape, on the CPU.

The JAX side runs on ``tests/conftest.py``'s 8 virtual CPU devices
(``build_mesh(MeshConfig(data=D, model=M))``); the port's mesh of the same
shape is over ``[torch.device("cpu")] * 8``, where each entry runs the
plain versions of K1 and K2 (``ops/lloyd.py``).

Tolerances, and why:
- init centers bit-equal on every mesh shape: the sample draws the valid
  rows' global indices, which padding does not move;
- integer-valued rows: centers, counts, ``n_iter`` and predictions equal
  to the single-device fit (every float32 sum is exact); ``compute_cost``
  within rtol 1e-6 (the distances to mean centers are not integers, so
  their float32 sum depends on its order);
- float blobs against the JAX fit on the same mesh shape: ``n_iter`` and
  counts equal, centers within atol 1e-4, cost within rtol 1e-4 (the JAX
  package's own cross-process tolerances, ``tests/test_distributed.py``:
  float32 sums in another order);
- silhouette within 1e-5 of the JAX package's (the same O(n·k) formula,
  summed in another order);
- the model axis' owner rule: the counts summed over the model shards
  equal the bincount of the global argmin (K1 and K2 share one d²).
"""

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.config import (
    MeshConfig as JMeshConfig,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import parallel as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models import kmeans as PK
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops import lloyd

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
SHAPES = [(1, 1), (8, 1), (4, 2), (2, 4)]
N, D, K = 4096, 8, 16


def _mesh(shape):
    return P.build_mesh(port.MeshConfig(data=shape[0], model=shape[1]), CPU8)


def _blobs(seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 3, size=(K, D))
    return (centers[rng.integers(0, K, N)] + rng.normal(scale=0.3, size=(N, D))).astype(
        np.float32)


def _integers(seed=1):
    return np.random.default_rng(seed).integers(-8, 8, size=(N, D)).astype(np.float32)


@pytest.fixture(scope="module")
def blobs():
    return _blobs()


@pytest.fixture(scope="module")
def integers():
    x = _integers()
    return x, port.KMeans(k=K, seed=0, max_iter=20).fit(x, device="cpu")


@pytest.mark.parametrize("shape", SHAPES)
def test_init_centers_bit_equal_on_every_mesh(shape, blobs):
    est = port.KMeans(k=K, seed=0)
    single = est._init_centers(port.device_dataset(blobs, device="cpu"))
    got = est._init_centers(P.device_dataset(blobs, mesh=_mesh(shape)))
    np.testing.assert_array_equal(got, single)
    jmesh = J.parallel.build_mesh(JMeshConfig(data=shape[0], model=shape[1]))
    jest = J.KMeans(k=K, seed=0)
    want = jest._init_centers(J.parallel.device_dataset(blobs, mesh=jmesh), jmesh)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_integer_rows_fit_equals_the_single_device_fit(shape, integers):
    x, ref = integers
    mesh = _mesh(shape)
    got = port.KMeans(k=K, seed=0, max_iter=20).fit(x, mesh=mesh)
    assert got.n_iter == ref.n_iter
    np.testing.assert_array_equal(got.cluster_centers, ref.cluster_centers)
    np.testing.assert_array_equal(got.cluster_sizes, ref.cluster_sizes)
    ds = P.device_dataset(x, mesh=mesh)
    np.testing.assert_array_equal(P.unpad(got.predict(ds.x), N), ref.predict_numpy(x, "cpu"))
    assert got.compute_cost(ds) == pytest.approx(ref.compute_cost(x, device="cpu"), rel=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_float_fit_matches_jax_on_the_same_mesh(shape, blobs):
    jmesh = J.parallel.build_mesh(JMeshConfig(data=shape[0], model=shape[1]))
    jm = J.KMeans(k=K, seed=0, max_iter=20).fit(blobs, mesh=jmesh)
    pm = port.KMeans(k=K, seed=0, max_iter=20).fit(blobs, mesh=_mesh(shape))
    assert pm.n_iter == jm.n_iter
    np.testing.assert_array_equal(pm.cluster_sizes, np.asarray(jm.cluster_sizes))
    np.testing.assert_allclose(pm.cluster_centers, np.asarray(jm.cluster_centers), atol=1e-4)
    np.testing.assert_allclose(pm.training_cost, jm.training_cost, rtol=1e-4)


def test_one_entry_mesh_is_the_single_device_fit(blobs):
    ref = port.KMeans(k=K, seed=0).fit(blobs, device="cpu")
    got = port.KMeans(k=K, seed=0).fit(blobs, mesh=P.single_device_mesh("cpu"))
    np.testing.assert_array_equal(got.cluster_centers, ref.cluster_centers)
    assert got.training_cost == ref.training_cost and got.n_iter == ref.n_iter
    ds = P.device_dataset(blobs, mesh=P.single_device_mesh("cpu"))
    assert isinstance(ds, port.DeviceDataset)


def test_a_device_dataset_fits_on_a_mesh_as_its_shards(integers):
    x, ref = integers
    got = port.KMeans(k=K, seed=0, max_iter=20).fit(port.device_dataset(x, device="cpu"),
                                                    mesh=_mesh((8, 1)))
    np.testing.assert_array_equal(got.cluster_centers, ref.cluster_centers)
    sds = P.sharding.shard_dataset(port.device_dataset(x[:4093], device="cpu"), _mesh((8, 1)))
    assert sds.n_padded == 4096 and float(sds.count()) == 4093.0


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_model_axis_counts_are_the_bincount_of_the_global_argmin(shape, blobs):
    rng = np.random.default_rng(5)
    x = (blobs + rng.normal(scale=2.0, size=blobs.shape)).astype(np.float32)  # many near ties
    lloyd_ = PK._ShardedLloyd(P.device_dataset(x, mesh=_mesh(shape)), K, cosine=False)
    centers = torch.from_numpy(x[rng.choice(N, K, replace=False)].copy())
    sums, counts, cost = lloyd_.stats(centers, PK.lloyd_stats_model)
    assign, mind2 = lloyd.fused_assign_plain(torch.from_numpy(x), centers, torch.ones(K))
    np.testing.assert_array_equal(counts.numpy(), np.bincount(assign.numpy(), minlength=K))
    want = np.zeros((K, D), np.float64)
    np.add.at(want, assign.numpy(), x.astype(np.float64))
    np.testing.assert_allclose(sums.numpy(), want, rtol=1e-5, atol=1e-3)
    assert float(cost) == pytest.approx(float(mind2.double().sum()), rel=1e-6)


def test_silhouette_over_the_mesh_matches_jax(blobs, mesh8):
    jm = J.KMeans(k=K, seed=0).fit(blobs, mesh=mesh8)
    jds = J.parallel.device_dataset(blobs, mesh=mesh8)
    want = J.ClusteringEvaluator().evaluate(jds, jm.predict(jds.x), k=K)
    pm = port.KMeans(k=K, seed=0).fit(blobs, mesh=_mesh((8, 1)))
    ds = P.device_dataset(blobs, mesh=_mesh((8, 1)))
    got = port.ClusteringEvaluator().evaluate(ds, pm.predict(ds.x), k=K)
    assert abs(got - want) < 1e-5
    host = port.ClusteringEvaluator().evaluate(ds, pm.predict_numpy(blobs, device="cpu"))
    assert abs(host - got) < 1e-6


def test_mesh_fitted_model_loads_in_the_jax_package(tmp_path, blobs):
    pm = port.KMeans(k=K, seed=0).fit(blobs, mesh=_mesh((4, 2)))
    path = str(tmp_path / "km")
    pm.write().overwrite().save(path)
    jm = J.load_model(path)
    np.testing.assert_array_equal(np.asarray(jm.cluster_centers), pm.cluster_centers)
    np.testing.assert_array_equal(np.asarray(jm.predict_numpy(blobs)),
                                  pm.predict_numpy(blobs, device="cpu"))
    back = port.load_model(path)
    np.testing.assert_array_equal(back.cluster_centers, pm.cluster_centers)


def test_partials_protocol_honours_the_mesh(integers):
    x, _ = integers
    km = port.KMeans(k=K, seed=0, warm_start_centers=x[:K])
    state = km.init_partials_state(D)
    one = km.partial_fit_stats(x, state=state, device="cpu")
    for shape in [(8, 1), (2, 4)]:
        got = km.partial_fit_stats(x, state=state, mesh=_mesh(shape), device="cpu")
        for key in ("sums", "counts", "cost"):
            np.testing.assert_array_equal(got.stats[key], one.stats[key])
    init_one = km.local_init_stats(x, device="cpu").stats["candidates"]
    init_mesh = km.local_init_stats(x, mesh=_mesh((4, 2))).stats["candidates"]
    np.testing.assert_array_equal(init_mesh, init_one)


def test_other_estimators_fit_on_a_mesh_of_more_than_one_shard(blobs):
    """The estimators and paths that raised until slice 8c-4 run over the
    mesh and never gather the shards: LDA (resident and out of core) and
    the session's fused SQL route, whose rows land as a ShardedDataset.
    LinearSVC and NaiveBayes, which raised until slice 8c-3, fit over the
    mesh, resident and out of core (``tests/test_torch_sharded_estimators.py``
    holds them to the JAX package; ``test_torch_sharded_recommenders.py``
    LDA and the SQL route)."""
    mesh = _mesh((4, 1))
    yb = (blobs[:, 0] > 0).astype(np.float32)
    counts = np.abs(np.round(blobs))
    session = port.Session(port.PipelineConfig(), mesh=mesh)
    try:
        session.register_table("events", port.Table.from_dict(
            {"a": blobs[:, 0].astype(np.float64), "b": blobs[:, 1].astype(np.float64)}))
        ds = session.sql_to_device("SELECT a, b FROM events WHERE a > 0",
                                   feature_cols=("a", "b"))
        assert isinstance(ds, P.sharding.ShardedDataset) and ds.mesh == mesh
        assert float(ds.count()) == float((blobs[:, 0] > 0).sum())
    finally:
        session.stop()
    one = port.LDA(k=2, max_iter=2).fit(counts, device="cpu")
    got = port.LDA(k=2, max_iter=2).fit(counts, mesh=mesh)
    assert got.lam.shape == one.lam.shape and got.n_docs_trained == one.n_docs_trained
    port.LDA(k=2, max_iter=2).fit(port.HostDataset(x=counts, max_device_rows=512), mesh=mesh)
    port.LinearSVC().fit((blobs, yb), mesh=mesh)
    port.NaiveBayes(model_type="gaussian").fit((blobs, yb), mesh=mesh)
    port.LinearSVC().fit(port.HostDataset(x=blobs, y=yb, max_device_rows=512), mesh=mesh)
    lr = port.LinearRegression().fit((blobs, blobs[:, 0]), mesh=P.single_device_mesh("cpu"))
    assert lr.coefficients.device == torch.device("cpu")


def test_unported_kmeans_options_on_a_mesh_raise(blobs, tmp_path):
    """The two KMeans options that raised over shards until slice 8c-1 run
    there: bf16 on a model axis is the (1, 1) bf16 fit up to the rows that
    bf16's rounding leaves near a tie (centers within 1e-4: float32 sums in
    another order), and a checkpointed (4, 1) fit is the uninterrupted one,
    bit for bit; a dataset on another mesh still refuses the mesh given."""
    kw = dict(k=K, seed=0, max_iter=8, matmul_precision="bf16")
    ref = port.KMeans(**kw).fit(blobs, device="cpu")
    got = port.KMeans(**kw).fit(blobs, mesh=_mesh((4, 2)))
    assert got.n_iter == ref.n_iter
    np.testing.assert_array_equal(got.cluster_sizes, ref.cluster_sizes)
    np.testing.assert_allclose(got.cluster_centers, ref.cluster_centers, atol=1e-4)
    plain = port.KMeans(k=K, seed=0, max_iter=8).fit(blobs, mesh=_mesh((4, 1)))
    ckpt = port.KMeans(k=K, seed=0, max_iter=8, checkpoint_dir=str(tmp_path)).fit(
        blobs, mesh=_mesh((4, 1)))
    np.testing.assert_array_equal(ckpt.cluster_centers, plain.cluster_centers)
    assert ckpt.n_iter == plain.n_iter and ckpt.training_cost == plain.training_cost
    with pytest.raises(ValueError, match="not on the mesh given"):
        port.KMeans(k=K).fit(P.device_dataset(blobs, mesh=_mesh((4, 1))), mesh=_mesh((8, 1)))


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_data_axis_fit_equals_single_device_on_integer_rows(fused, integers):
    x, _ = integers
    kw = dict(k=K, seed=0, max_iter=10, matmul_precision="bf16", fused_stats=fused,
              chunk_rows=256)
    ref = port.KMeans(**kw).fit(x, device="cpu")
    got = port.KMeans(**kw).fit(x, mesh=_mesh((8, 1)))
    assert got.n_iter == ref.n_iter
    np.testing.assert_array_equal(got.cluster_centers, ref.cluster_centers)


def test_cosine_and_on_iteration_over_the_mesh(blobs):
    seen = []
    kw = dict(k=K, seed=0, max_iter=8, distance_measure="cosine")
    ref = port.KMeans(**kw).fit(blobs, device="cpu")
    got = port.KMeans(**kw).fit(blobs, mesh=_mesh((4, 2)),
                                on_iteration=lambda it, cost, move: seen.append(it))
    assert seen == list(range(1, got.n_iter + 1))
    np.testing.assert_array_equal(got.cluster_sizes, ref.cluster_sizes)
    np.testing.assert_allclose(got.cluster_centers, ref.cluster_centers, atol=1e-5)

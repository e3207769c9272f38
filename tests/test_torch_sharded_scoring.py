"""Sharded bulk scoring: ``bulk_score(mesh=)``, ``ShardedScorer(mesh=)``
and ``ops.distance.assign_clusters_chunked`` over meshes, against the
JAX package's on the same mesh shape and the port's one-device predict,
on the CPU.

Tolerances, and why:
- KMeans assignments ``==`` (the argmin is row-local, the centers the same
  float32 bits in both packages);
- LinearRegression predictions against one device at rtol 1e-6 (on the
  CPU a matrix-vector product blocks by the row count, so a shard's rows
  can round 1 ulp apart from the whole tensor's), against the JAX
  package's at its own rtol 1e-5, atol 1e-6 (JAX ``tests/test_serving.py``);
- K2 once a shard a chunk: counted at the port's ``fused_assign`` call.
"""

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.config import (
    MeshConfig as JMeshConfig,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.ops import distance as jdist
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import parallel as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models import kmeans as pkm
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops import distance as pdist

torch.set_num_threads(1)

SHAPES = [(1, 1), (8, 1), (4, 2)]


def _mesh(shape):
    return P.build_mesh(port.MeshConfig(data=shape[0], model=shape[1]),
                        [torch.device("cpu")] * 8)


def _jmesh(shape):
    return J.parallel.build_mesh(JMeshConfig(data=shape[0], model=shape[1]))


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(1003, 4)).astype(np.float32)
    centers = x[rng.choice(len(x), 9, replace=False)].copy()
    return x, centers


def _count_k2(monkeypatch) -> list:
    calls = []
    real = pkm.fused_assign

    def counted(x, *a):
        calls.append(x.shape[0])
        return real(x, *a)

    monkeypatch.setattr(pkm, "fused_assign", counted)
    return calls


@pytest.mark.parametrize("shape", SHAPES)
def test_bulk_score_and_scorer_equal_jax_and_predict(shape, rows, monkeypatch):
    x, centers = rows
    pm = port.KMeansModel(cluster_centers=centers)
    jm = J.KMeansModel(cluster_centers=centers)
    want = pm.predict_numpy(x, device="cpu")
    mesh, jmesh = _mesh(shape), _jmesh(shape)
    calls = _count_k2(monkeypatch)
    got = port.serve.bulk_score(pm, x, mesh=mesh)
    assert len(calls) == shape[0]                 # one chunk: K2 once a data shard
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(J.serve.bulk_score(jm, x, mesh=jmesh)))
    calls.clear()
    chunked = port.serve.bulk_score(pm, x, mesh=mesh, chunk_rows=100)
    chunk = -(-100 // shape[0]) * shape[0]        # round_rows
    assert len(calls) == -(-len(x) // chunk) * shape[0]
    np.testing.assert_array_equal(chunked, want)
    np.testing.assert_array_equal(
        chunked, np.asarray(J.serve.bulk_score(jm, x, mesh=jmesh, chunk_rows=100)))
    scorer = port.serve.ShardedScorer(pm, mesh=mesh, chunk_rows=100).warmup()
    assert scorer.chunk_rows == chunk
    np.testing.assert_array_equal(scorer.score(x), want)
    np.testing.assert_array_equal(scorer.score(x[:5]), want[:5])
    jscorer = J.serve.ShardedScorer(jm, mesh=jmesh, chunk_rows=100).warmup()
    np.testing.assert_array_equal(scorer.score(x), np.asarray(jscorer.score(x)))


@pytest.mark.parametrize("shape", SHAPES)
def test_bulk_score_linear_regression_over_a_mesh(shape, rows):
    x, _ = rows
    coef, intercept = np.array([0.5, -1.0, 2.0, 0.25]), 0.75
    pm = port.linear_regression_model_from_jax_arrays(coef, intercept)
    jm = J.LinearRegressionModel(coefficients=coef.astype(np.float32),
                                 intercept=np.float32(intercept))
    want = pm.predict_numpy(x, device="cpu")
    for kw in ({}, {"chunk_rows": 64}):
        got = port.serve.bulk_score(pm, x, mesh=_mesh(shape), **kw)
        np.testing.assert_allclose(got, want, rtol=1e-6)
        np.testing.assert_allclose(got, np.asarray(J.serve.bulk_score(jm, x, mesh=_jmesh(shape),
                                                                      **kw)),
                                   rtol=1e-5, atol=1e-6)
    scorer = port.serve.ShardedScorer(pm, mesh=_mesh(shape), chunk_rows=64).warmup()
    np.testing.assert_allclose(scorer.score(x), want, rtol=1e-6)


def test_one_device_scoring_keeps_its_keyword_device(rows):
    x, centers = rows
    pm = port.KMeansModel(cluster_centers=centers)
    want = pm.predict_numpy(x, device="cpu")
    np.testing.assert_array_equal(port.serve.bulk_score(pm, x, device="cpu", chunk_rows=64), want)
    np.testing.assert_array_equal(
        port.serve.bulk_score(pm, x, mesh=P.single_device_mesh("cpu"), chunk_rows=64), want)
    with pytest.raises(ValueError, match="mesh or a device"):
        port.serve.bulk_score(pm, x, mesh=_mesh((8, 1)), device="cpu")
    with pytest.raises(ValueError, match="mesh or a device"):
        port.serve.ShardedScorer(pm, mesh=_mesh((8, 1)), device="cpu")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("chunk", [64, pdist.ASSIGN_CHUNK])
def test_assign_clusters_chunked_equals_jax(shape, chunk, rows):
    x, centers = rows
    ds = P.device_dataset(x, mesh=_mesh(shape))
    jds = J.parallel.device_dataset(x, mesh=_jmesh(shape))
    got = pdist.assign_clusters_chunked(ds.x, torch.from_numpy(centers), chunk)
    want = np.asarray(jdist.assign_clusters_chunked(jds.x, centers, chunk))[: len(x)]
    np.testing.assert_array_equal(P.unpad(got, len(x)), want)
    one = pdist.assign_clusters_chunked(torch.from_numpy(x), torch.from_numpy(centers), chunk)
    assert one.dtype == torch.int32
    np.testing.assert_array_equal(one.numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jdist.assign_clusters_chunked(x, centers, chunk)), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_assign_clusters_chunked_takes_chunk_for_parity_only(shape, rows, monkeypatch):
    """``chunk`` is the reference's row tile, kept in the signature; K2
    builds no (n, k) tile, so every chunk gives one call a data shard on
    all of its rows, and the same assignment."""
    from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.ops import lloyd as pl

    x, centers = rows
    calls = []
    real = pl.fused_assign

    def counted(xs, *a):
        calls.append(xs.shape[0])
        return real(xs, *a)

    monkeypatch.setattr(pl, "fused_assign", counted)
    ds = P.device_dataset(x, mesh=_mesh(shape))
    c = torch.from_numpy(centers)
    outs = []
    for chunk in (1, 64, pdist.ASSIGN_CHUNK):
        calls.clear()
        outs.append(P.unpad(pdist.assign_clusters_chunked(ds.x, c, chunk), len(x)))
        assert calls == [ds.n_padded // shape[0]] * shape[0]
        calls.clear()
        one = pdist.assign_clusters_chunked(torch.from_numpy(x), c, chunk)
        assert calls == [len(x)]
        np.testing.assert_array_equal(one.numpy(), outs[0])
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])

"""The clustering family over a (data, model) mesh: BisectingKMeans,
StreamingKMeans, the checkpointed KMeans and GaussianMixture fits and
bf16 KMeans on a model axis, against the port's one-device path and the
JAX package on the same mesh shape, on the CPU.

The JAX side runs on ``tests/conftest.py``'s 8 virtual CPU devices; the
port's mesh of the same shape is over ``[torch.device("cpu")] * 8``, where
each entry runs the plain versions of K1 and K2.

Tolerances, and why:
- a (1, 1) mesh is the one-device fit, bit for bit (one shard's sum is
  its statistics as they are);
- BisectingKMeans over (8, 1) and (4, 2): the same splits, sizes and
  ``n_iter`` as one device and as the JAX fit on that mesh, centers at
  atol 1e-4 and the cost at rtol 1e-5 (``tests/test_torch_bisecting_kmeans.py``'s
  tolerances: the root's float32 sums in another order); on small integer
  rows every float32 root sum is exact and the fit is ``==`` one device;
- StreamingKMeans sharded against the JAX sharded stream: centers at rtol
  1e-5, atol 1e-5 and weights at rtol 1e-6 (``tests/test_torch_streaming_kmeans.py``'s:
  the per-cluster sums in another order); against the port's one-device
  stream the same, and ``==`` on integer rows;
- a checkpointed fit killed and resumed over (4, 1) is ``==`` the
  uninterrupted (4, 1) fit (the resumed centers are the committed float32
  bits, and every later step is the same arithmetic);
- the checkpoint signature's ``"data"`` equals the JAX package's: the same
  strided rows of the global padded array, in their own dtype;
- bf16 over a model axis against the JAX fit on (4, 2): ``n_iter`` and
  sizes equal, centers within 1e-4 (``tests/test_torch_precision.py``'s
  reduced-precision tolerances); the final exact cost at rtol 5e-5 against
  JAX and the port's one-device fit.  Both packages take the final cost as
  Σ (x² − 2x·c + c²) in float32, which cancels on these rows (offset by
  20, |x|² ≈ 1,600), and the model axis sums the owners' costs in another
  order: with the same centers, the one-device port's cost reads 2.2e-5
  and JAX's 1.0e-6 from the float64 cost, the (4, 2) port's 7.4e-6 from
  the one-device port's (measured here);
- fractional weights: sizes at rtol 1e-6 (float32 sums in another order).
"""

import json

import numpy as np
import pytest
import torch

import clustermachinelearningforhospitalnetworks_apache_spark_tpu as J
import clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch as port
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.config import (
    MeshConfig as JMeshConfig,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu.models.streaming_kmeans import (
    StreamingKMeans as JaxStreamingKMeans,
)
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch import parallel as P
from clustermachinelearningforhospitalnetworks_apache_spark_tpu_torch.models import (
    streaming_kmeans as psk,
)

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8


def _mesh(shape):
    return P.build_mesh(port.MeshConfig(data=shape[0], model=shape[1]), CPU8)


def _jmesh(shape):
    return J.parallel.build_mesh(JMeshConfig(data=shape[0], model=shape[1]))


def _blobs(n=2000, d=3, k=6, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 6, (k, d))
    return (c[rng.integers(0, k, n)] + rng.normal(scale=0.7, size=(n, d)) + 20.0).astype(
        np.float32)


def _small_integers(n=2000, d=3, seed=1):
    rng = np.random.default_rng(seed)
    c = rng.integers(-20, 20, size=(6, d))
    return (c[rng.integers(0, 6, n)] + rng.integers(-2, 3, size=(n, d))).astype(np.float32)


# ------------------------------------------------------------ BisectingKMeans
@pytest.mark.parametrize("shape", [(1, 1), (8, 1), (4, 2)])
@pytest.mark.parametrize("strategy", ["level", "sequential"])
def test_bisecting_over_the_mesh(shape, strategy):
    x = _blobs()
    kw = dict(k=5, seed=1, strategy=strategy, n_restarts=1)
    one = port.BisectingKMeans(**kw).fit(x, device="cpu")
    got = port.BisectingKMeans(**kw).fit(x, mesh=_mesh(shape))
    jm = J.BisectingKMeans(**kw).fit(x, mesh=_jmesh(shape))
    assert got.fit_info["splits"] == one.fit_info["splits"]
    if shape == (1, 1):
        np.testing.assert_array_equal(got.cluster_centers, one.cluster_centers)
        assert got.training_cost == one.training_cost
    for ref in (one, jm):
        np.testing.assert_array_equal(got.cluster_sizes, np.asarray(ref.cluster_sizes))
        assert got.n_iter == ref.n_iter
        np.testing.assert_allclose(got.cluster_centers, np.asarray(ref.cluster_centers),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got.training_cost, ref.training_cost, rtol=1e-5)
    # predict over the mesh: K2 a shard, == the one-device predict
    ds = P.device_dataset(x, mesh=_mesh(shape))
    np.testing.assert_array_equal(P.unpad(got.predict(ds.x), len(x)),
                                  got.predict_numpy(x, device="cpu"))


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_bisecting_integer_rows_equal_one_device(shape):
    x = _small_integers()
    kw = dict(k=6, seed=0, n_restarts=2)
    one = port.BisectingKMeans(**kw).fit(x, device="cpu")
    got = port.BisectingKMeans(**kw).fit(x, mesh=_mesh(shape))
    assert got.fit_info["splits"] == one.fit_info["splits"]
    np.testing.assert_array_equal(got.cluster_centers, one.cluster_centers)
    np.testing.assert_array_equal(got.cluster_sizes, one.cluster_sizes)
    assert got.training_cost == one.training_cost


@pytest.mark.parametrize("kw", [dict(distance_measure="cosine"), dict(weighted=True)],
                         ids=["cosine", "weighted"])
def test_bisecting_cosine_and_weights_over_the_mesh(kw):
    x = _blobs(seed=4)
    data = x
    if kw.pop("weighted", False):
        w = np.random.default_rng(5).uniform(0.2, 2.0, len(x)).astype(np.float32)
        data = (x, np.zeros(len(x), np.float32), w)
    est = port.BisectingKMeans(k=4, seed=2, n_restarts=1, **kw)
    one = est.fit(data, device="cpu")
    got = est.fit(data, mesh=_mesh((8, 1)))
    jm = J.BisectingKMeans(k=4, seed=2, n_restarts=1, **kw).fit(data, mesh=_jmesh((8, 1)))
    for ref in (one, jm):
        # fractional weights: the sizes are float32 sums in another order
        np.testing.assert_allclose(got.cluster_sizes, np.asarray(ref.cluster_sizes), rtol=1e-6)
        np.testing.assert_allclose(got.cluster_centers, np.asarray(ref.cluster_centers),
                                   rtol=1e-5, atol=1e-4)


def test_bisecting_out_of_core_over_a_mesh_raises():
    """BisectingKMeans fits a HostDataset over a mesh since slice 8c-2 (on
    integer rows the (4, 1) fit is the one-device out-of-core fit, bit for
    bit: ``tests/test_torch_sharded_outofcore.py`` holds it to the JAX
    package); LinearSVC's and NaiveBayes' out-of-core fits do since slice
    8c-3 (``==`` one device on integer counts for NaiveBayes), and LDA's,
    left to slice 8c-4, still raises over a mesh of more than one shard."""
    x = np.round(_blobs(n=256))
    one = port.BisectingKMeans(k=2).fit(port.HostDataset(x=x, max_device_rows=64), device="cpu")
    got = port.BisectingKMeans(k=2).fit(port.HostDataset(x=x, max_device_rows=64),
                                        mesh=_mesh((4, 1)))
    np.testing.assert_array_equal(got.cluster_centers, one.cluster_centers)
    np.testing.assert_array_equal(got.cluster_sizes, one.cluster_sizes)
    yb = (x[:, 0] > 0).astype(np.float32)
    counts = np.abs(x)
    hd = port.HostDataset(x=counts, y=yb, max_device_rows=64)
    nb1 = port.NaiveBayes().fit(hd, device="cpu")
    nb4 = port.NaiveBayes().fit(hd, mesh=_mesh((4, 1)))
    np.testing.assert_array_equal(nb4.theta, nb1.theta)
    port.LinearSVC().fit(port.HostDataset(x=x, y=yb, max_device_rows=64), mesh=_mesh((4, 1)))
    with pytest.raises(NotImplementedError, match="slice 8c-4"):
        port.LDA(k=2).fit(port.HostDataset(x=counts, max_device_rows=64), mesh=_mesh((4, 1)))


# ------------------------------------------------------------ StreamingKMeans
def _stream_batches(sizes, seed=0, integers=False):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 4, size=(4, 3))
    out = []
    for n in sizes:
        if integers:
            x = np.round(centers[rng.integers(0, 4, n)]) + rng.integers(-1, 2, size=(n, 3))
        else:
            x = centers[rng.integers(0, 4, n)] + rng.normal(scale=0.4, size=(n, 3))
        out.append(x.astype(np.float32))
    return out


def _count_stats(monkeypatch) -> list:
    """Counts the per-shard batch statistics (K1 a shard on the card)."""
    calls = []
    real = psk._batch_stats

    def counted(x, w, centers):
        calls.append(x.shape[0])
        return real(x, w, centers)

    monkeypatch.setattr(psk, "_batch_stats", counted)
    return calls


def test_streaming_micro_batches_run_single_device(monkeypatch):
    """The reference's adaptive placement (JAX
    ``tests/test_stream_pipeline.py::test_streaming_micro_batches_run_single_device``):
    a 100-row micro-batch stays on one device of an 8-mesh; the override
    ``shard_min_rows_per_device=1`` spreads it over the 8 data shards."""
    calls = _count_stats(monkeypatch)
    sk = port.StreamingKMeans(k=2, seed=0)
    sk.update(np.zeros((100, 2), np.float32), mesh=_mesh((8, 1)))
    assert calls == [100]
    calls.clear()
    sk2 = port.StreamingKMeans(k=2, seed=0, shard_min_rows_per_device=1)
    sk2.update(np.zeros((100, 2), np.float32), mesh=_mesh((8, 1)))
    assert calls == [13] * 8          # pad_rows(100, 8) = 104 rows, 13 a shard
    np.testing.assert_array_equal(sk.latest_model.cluster_centers,
                                  sk2.latest_model.cluster_centers)


@pytest.mark.parametrize("rule", [dict(decay_factor=1.0), dict(half_life=2.0),
                                  dict(half_life=150.0, time_unit="points")])
def test_streaming_sharded_matches_jax_sharded_stream(rule, monkeypatch):
    calls = _count_stats(monkeypatch)
    batches = _stream_batches([200, 240, 160, 200])
    sp = port.StreamingKMeans(k=4, seed=3, shard_min_rows_per_device=1, **rule)
    sj = JaxStreamingKMeans(k=4, seed=3, shard_min_rows_per_device=1, **rule)
    one = port.StreamingKMeans(k=4, seed=3, **rule)
    for b in batches:
        sp.update(b, mesh=_mesh((8, 1)))
        sj.update(b, mesh=_jmesh((8, 1)))
        one.update(b, device="cpu")
    assert len(calls) == 8 * len(batches) + len(batches)
    pm = sp.latest_model
    for ref in (sj.latest_model, one.latest_model):
        assert pm.n_iter == ref.n_iter
        np.testing.assert_allclose(pm.cluster_centers, np.asarray(ref.cluster_centers),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(pm.cluster_weights, np.asarray(ref.cluster_weights),
                                   rtol=1e-6)


def test_streaming_sharded_integer_rows_equal_one_device_and_update_many():
    batches = _stream_batches([200, 200, 200, 200], seed=2, integers=True)
    kw = dict(k=4, seed=0, half_life=3.0)
    one = port.StreamingKMeans(**kw)
    sharded = port.StreamingKMeans(shard_min_rows_per_device=1, **kw)
    drained = port.StreamingKMeans(shard_min_rows_per_device=1, **kw)
    for b in batches:
        one.update(b, device="cpu")
        sharded.update(b, mesh=_mesh((4, 2)))
    drained.update_many(batches, mesh=_mesh((4, 2)))
    for sk in (sharded, drained):
        assert torch.equal(sk._centers, one._centers)
        assert torch.equal(sk._weights, one._weights)
        assert torch.equal(sk._weights_lo, one._weights_lo)


def test_streaming_one_entry_mesh_and_datasets_run_where_they_lie():
    batches = _stream_batches([150, 150], seed=5)
    one = port.StreamingKMeans(k=4, seed=1)
    on_mesh = port.StreamingKMeans(k=4, seed=1, shard_min_rows_per_device=1)
    for b in batches:
        one.update(b, device="cpu")
        on_mesh.update(b, mesh=P.single_device_mesh("cpu"))
    assert torch.equal(one._centers, on_mesh._centers)
    sds = P.device_dataset(batches[0], mesh=_mesh((4, 1)))
    ref = port.StreamingKMeans(k=4, seed=1, shard_min_rows_per_device=1)
    ref.update(batches[0], mesh=_mesh((4, 1)))
    # a ShardedDataset keeps its own mesh, whatever the threshold says
    got = port.StreamingKMeans(k=4, seed=1).update(sds, mesh=_mesh((8, 1)))
    assert torch.equal(got._centers, ref._centers)
    with pytest.raises(ValueError, match="mesh or a device"):
        port.StreamingKMeans(k=4).update(batches[0], mesh=_mesh((4, 1)), device="cpu")


# ------------------------------------------------- checkpoints over shards
class Preempt(Exception):
    pass


def _commit_signature(path) -> dict:
    with open(path / "COMMIT") as f:
        return json.load(f)["signature"]


def test_kmeans_checkpoint_kill_resume_over_shards(tmp_path):
    # structureless rows: Lloyd is still moving at the kill
    x = np.random.default_rng(6).normal(size=(1500, 4)).astype(np.float32)
    base = dict(k=5, seed=0, max_iter=14, tol=0.0)
    mesh = _mesh((4, 1))
    plain = port.KMeans(**base).fit(x, mesh=mesh)
    est = port.KMeans(checkpoint_dir=str(tmp_path / "km"), checkpoint_every=1, **base)

    def bomb(it, cost, move):
        if it == 5:
            raise Preempt()

    with pytest.raises(Preempt):
        est.fit(x, mesh=mesh, on_iteration=bomb)
    seen = []
    resumed = est.fit(x, mesh=mesh, on_iteration=lambda it, c, m: seen.append(it))
    assert seen[0] == 6
    np.testing.assert_array_equal(resumed.cluster_centers, plain.cluster_centers)
    np.testing.assert_array_equal(resumed.cluster_sizes, plain.cluster_sizes)
    assert resumed.training_cost == plain.training_cost and resumed.n_iter == plain.n_iter


def test_gmm_checkpoint_kill_resume_over_shards(tmp_path):
    x = _blobs(n=1200, d=3, k=3, seed=7)
    base = dict(k=3, seed=1, max_iter=10, tol=0.0)
    mesh = _mesh((4, 1))
    plain = port.GaussianMixture(**base).fit(x, mesh=mesh)
    est = port.GaussianMixture(checkpoint_dir=str(tmp_path / "gmm"), checkpoint_every=3, **base)

    def bomb(it, ll):
        if it == 5:
            raise Preempt()

    with pytest.raises(Preempt):
        est.fit(x, mesh=mesh, on_iteration=bomb)
    seen = []
    resumed = est.fit(x, mesh=mesh, on_iteration=lambda it, ll: seen.append(it))
    assert seen[0] == 4
    for a in ("means", "covariances", "weights"):
        np.testing.assert_array_equal(getattr(resumed, a), getattr(plain, a))
    assert resumed.log_likelihood == plain.log_likelihood


@pytest.mark.parametrize("shape", [(4, 1), (8, 1), (2, 2)])
@pytest.mark.parametrize("family", ["KMeans", "GaussianMixture"])
def test_checkpoint_signature_data_equals_jax(shape, family, tmp_path):
    """n = 1,001 rows: the padding puts pad rows in the strided sample."""
    x = _blobs(n=1001, d=3, seed=8)
    kw = dict(k=3, seed=0, max_iter=1, checkpoint_every=1)
    getattr(port, family)(checkpoint_dir=str(tmp_path / "p"), **kw).fit(x, mesh=_mesh(shape))
    getattr(J, family)(checkpoint_dir=str(tmp_path / "j"), **kw).fit(x, mesh=_jmesh(shape))
    sp, sj = _commit_signature(tmp_path / "p"), _commit_signature(tmp_path / "j")
    assert sp["data"] == sj["data"] and sp["n_padded"] == sj["n_padded"]
    if family == "KMeans":
        assert sp["k_pad"] == sj["k_pad"]


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_over_a_model_axis_matches_jax(fused):
    x = _blobs(n=2048, d=4, k=6, seed=9)
    kw = dict(k=6, seed=0, max_iter=10, matmul_precision="bf16", fused_stats=fused,
              chunk_rows=256)
    jm = J.KMeans(**kw).fit(x, mesh=_jmesh((4, 2)))
    pm = port.KMeans(**kw).fit(x, mesh=_mesh((4, 2)))
    one = port.KMeans(**kw).fit(x, device="cpu")
    for ref in (jm, one):
        assert pm.n_iter == ref.n_iter
        np.testing.assert_array_equal(pm.cluster_sizes, np.asarray(ref.cluster_sizes))
        np.testing.assert_allclose(pm.cluster_centers, np.asarray(ref.cluster_centers),
                                   atol=1e-4)
        np.testing.assert_allclose(pm.training_cost, ref.training_cost, rtol=5e-5)
